"""Guard against bench.py rot: its functions must stay importable and
runnable (tiny sizes, CPU), and the orchestration must keep its JSON
contract."""

import json
import subprocess
import sys
import types

import pytest


def _patch_tiny_benches(monkeypatch, bench):
    monkeypatch.setattr(bench, "bench_mfm_4mode", lambda: {
        "steps_per_sec_scan": 100.0, "steps_per_sec_host_loop": 10.0,
        "speedup": 10.0,
    })
    monkeypatch.setattr(
        bench, "bench_phi_four_mala", lambda: {"chain_steps_per_sec": 1.0}
    )
    monkeypatch.setattr(
        bench, "bench_pines_step", lambda: {"chain_steps_per_sec": 1.0}
    )
    monkeypatch.setattr(
        bench, "bench_mfm_steady",
        lambda *a, **k: {"iters_per_sec_median": 50.0,
                         "iters_per_sec_runs": [50.0]},
    )
    monkeypatch.setattr(
        bench, "bench_chain_scaling",
        lambda: {"chain_steps_kps_by_n_chain": {"1024": 1.0}},
    )
    monkeypatch.setattr(
        bench, "bench_pines_move_quality",
        lambda: {"train_time_s": 1.0, "ksd_u_is_resampled": 1.0,
                 "ksd_u_move_corrected": 0.1},
    )
    monkeypatch.setattr(
        bench, "bench_pines_flow_smc",
        lambda: {"train_time": 1.0, "smc_time": 1.0, "lmbda": 1.0,
                 "log_z": 500.0, "ess_fraction": 1.0},
    )
    monkeypatch.setattr(
        bench, "bench_new_examples",
        lambda: {"funnel": {"stein_u": 1.0},
                 "many_well_flow_smc": {"log_z": 164.0,
                                        "log_z_true": 164.7}},
    )
    monkeypatch.setattr(
        bench, "bench_roofline", lambda: {"mala_lgcp": {"pct_peak": 1.0}},
    )
    monkeypatch.setattr(
        bench, "bench_pines_north_star",
        lambda: {"n_chain": 4096, "iters_per_sec_median": 10.0,
                 "chain_steps_per_sec": 40960.0},
    )
    monkeypatch.setattr(
        bench, "bench_baselines",
        lambda: {"mfm": {"logpdf": {"mean": -1.0}}},
    )


class TestBench:
    @pytest.mark.slow
    def test_bench_functions_tiny(self, tmp_path, monkeypatch):
        sys.path.insert(0, ".")
        import bench

        out = bench.bench_mfm_4mode(n_iter=4)
        assert out["steps_per_sec_scan"] > 0
        assert out["steps_per_sec_host_loop"] > 0

        pf = bench.bench_phi_four_mala(n_chain=32, n_steps=10)
        assert pf["chain_steps_per_sec"] > 0

    @pytest.mark.slow
    def test_headline_line_is_json(self, tmp_path, monkeypatch, capsys):
        sys.path.insert(0, ".")
        import bench

        # run main with the tiny benches monkeypatched in (the real detail
        # benches run at benchmark sizes). MFM_BENCH_INPROCESS keeps every
        # bench in this process so the monkeypatched functions take effect
        # (the production path runs each bench in its own subprocess).
        monkeypatch.setenv("MFM_BENCH_INPROCESS", "1")
        _patch_tiny_benches(monkeypatch, bench)
        monkeypatch.chdir(tmp_path)
        bench.main()
        first_line = capsys.readouterr().out.strip().splitlines()[0]
        rec = json.loads(first_line)
        assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
        assert (tmp_path / "BENCH_DETAILS.json").exists()

    @pytest.mark.slow
    def test_headline_failure_is_machine_readable(self, tmp_path,
                                                  monkeypatch, capsys):
        """A failing headline must still emit the JSON line (value=null,
        error set) and exit nonzero — never a bare traceback."""
        sys.path.insert(0, ".")
        import bench

        monkeypatch.setenv("MFM_BENCH_INPROCESS", "1")

        def always_crash(*a, **k):
            raise RuntimeError("UNAVAILABLE: device process crashed")

        monkeypatch.setattr(bench, "bench_mfm_steady", always_crash)
        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit) as exc:
            bench.main()
        assert exc.value.code == 2
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
        assert rec["value"] is None
        assert "crashed" in rec["error"]

    @pytest.mark.slow
    def test_budget_skips_details_with_reason(self, tmp_path, monkeypatch,
                                              capsys):
        """With the global budget exhausted right after the headline, every
        detail bench must be skipped WITH a recorded reason — never a
        silent SIGKILL hole."""
        sys.path.insert(0, ".")
        import bench

        monkeypatch.setenv("MFM_BENCH_INPROCESS", "1")
        # headline fits; details find the budget gone (fake clock advances
        # past the budget the moment the headline bench returns)
        monkeypatch.setenv("MFM_BENCH_BUDGET_S", "1000")
        _patch_tiny_benches(monkeypatch, bench)

        real_time = bench.time.time
        t0 = real_time()
        state = {"offset": 0.0}

        def fake_time():
            return t0 + state["offset"]

        def steady(*a, **k):
            state["offset"] = 2000.0  # headline "takes" 2000s > budget
            return {"iters_per_sec_median": 50.0,
                    "iters_per_sec_runs": [50.0]}

        monkeypatch.setattr(bench, "bench_mfm_steady", steady)
        monkeypatch.setattr(bench.time, "time", fake_time)
        monkeypatch.chdir(tmp_path)
        bench.main()
        details = json.loads((tmp_path / "BENCH_DETAILS.json").read_text())
        assert details["mfm_pines_steady"]["iters_per_sec_median"] == 50.0
        for name in ("mfm_4mode", "chain_scaling", "baselines"):
            assert "budget" in details[name]["error"]

    @pytest.mark.slow
    def test_detail_prewrite_and_health(self, tmp_path, monkeypatch, capsys):
        """Every detail entry is written BEFORE its bench launches (so a
        SIGKILL'd parent still leaves a record) and a crashing bench's
        error is recorded in its entry."""
        sys.path.insert(0, ".")
        import bench

        monkeypatch.setenv("MFM_BENCH_INPROCESS", "1")
        monkeypatch.delenv("MFM_BENCH_BUDGET_S", raising=False)
        _patch_tiny_benches(monkeypatch, bench)

        seen_prewrite = {}
        real_isolated = bench.run_bench_isolated

        def spying_isolated(name, timeout=0):
            try:
                details = json.loads(
                    (tmp_path / "BENCH_DETAILS.json").read_text())
            except OSError:  # headline runs before the first dump
                details = {}
            seen_prewrite[name] = "never returned" in str(
                details.get(name, {}).get("error", ""))
            if name == "chain_scaling":
                return None, "bench child 'chain_scaling' rc=-9: boom"
            return real_isolated(name, timeout=timeout)

        monkeypatch.setattr(bench, "run_bench_isolated", spying_isolated)
        monkeypatch.chdir(tmp_path)
        bench.main()
        details = json.loads((tmp_path / "BENCH_DETAILS.json").read_text())
        assert all(seen_prewrite[n] for n in seen_prewrite if n != "headline")
        assert "rc=-9" in details["chain_scaling"]["error"]
        assert details["mfm_4mode"]["steps_per_sec_scan"] == 100.0

    def test_run_bench_isolated_parses_child_output(self, monkeypatch):
        """Subprocess-path plumbing: tagged JSON line extraction, timeout,
        and rc!=0 handling (no real child is spawned)."""
        sys.path.insert(0, ".")
        import bench

        monkeypatch.delenv("MFM_BENCH_INPROCESS", raising=False)

        def fake_run(cmd, **kw):
            assert cmd[1].endswith("bench.py") and cmd[2] == "--child"
            return types.SimpleNamespace(
                returncode=0, stderr="",
                stdout="noise\n" + bench._CHILD_TAG
                + json.dumps({"device": "d", "result": {"x": 1}}) + "\n",
            )

        monkeypatch.setattr(subprocess, "run", fake_run)
        payload, err = bench.run_bench_isolated("mfm_4mode", timeout=5)
        assert err is None and payload["result"] == {"x": 1}

        def fake_crash(cmd, **kw):
            return types.SimpleNamespace(
                returncode=1, stdout="", stderr="JaxRuntimeError: UNAVAILABLE"
            )

        monkeypatch.setattr(subprocess, "run", fake_crash)
        payload, err = bench.run_bench_isolated("mfm_4mode", timeout=5)
        assert payload is None and "UNAVAILABLE" in err

        def fake_timeout(cmd, **kw):
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 0))

        monkeypatch.setattr(subprocess, "run", fake_timeout)
        payload, err = bench.run_bench_isolated("mfm_4mode", timeout=5)
        assert payload is None and "timed out" in err
