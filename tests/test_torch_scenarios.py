"""The port's scenario runner against the reference's.

The manifest the port reads is its own copy, byte-equal to the
reference's.  Every simulator-driven scenario (the ``session``, ``crash``
and ``fleet`` kinds) at seed 0 on the CPU, with the reference's draws
injected into the port's fits, gives the reference's metrics and gate
outcomes.  Artifacts are schema-versioned, the module runs as a program,
the manifest's smoke subset runs, and the kinds the port does not run yet
raise before any scenario starts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.scenarios import runner as J
from repro_torch.scenarios import (SCHEMA_VERSION, UNPORTED_KINDS,
                                   load_manifest, run_manifest, run_scenario)
from repro_torch.scenarios import runner as P
from torch_parity import reference_draws  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = load_manifest()
SIMULATED = sorted(n for n, s in MANIFEST["scenarios"].items()
                   if s.get("kind", "session") in ("session", "crash",
                                                   "fleet"))


def test_manifest_copy_byte_equal_to_reference():
    assert P.DEFAULT_MANIFEST.read_bytes() == \
        J.DEFAULT_MANIFEST.read_bytes()
    assert P.DEFAULT_MANIFEST != J.DEFAULT_MANIFEST
    kinds = {s.get("kind", "session") for s in MANIFEST["scenarios"].values()}
    assert kinds == set(P._KINDS) | set(UNPORTED_KINDS)
    assert set(P._KINDS) == {"session", "crash", "serving", "fleet"}
    assert set(UNPORTED_KINDS) == {"elastic", "elastic_session"}


@pytest.mark.parametrize("name", SIMULATED)
def test_scenario_equals_reference_at_seed0(reference_draws, name):
    spec = MANIFEST["scenarios"][name]
    want = J.run_scenario(name, spec, seed=0)
    got = run_scenario(name, spec, seed=0, device="cpu")
    assert got["gates"] == want["gates"]
    assert got["ok"] == want["ok"] is True
    assert got["metrics"] == want["metrics"]
    assert {k: v for k, v in got.items()
            if k not in ("seconds", "metrics", "gates", "device")} == \
        {k: v for k, v in want.items()
         if k not in ("seconds", "metrics", "gates")}


def test_artifacts_schema_versioned(tmp_path):
    only = ["crash_restore", "stuck_knob"]
    summary = run_manifest(out_dir=tmp_path, run_id="t", only=only,
                           seeds=[0, 1], device="cpu")
    run_dir = tmp_path / "t"
    assert (tmp_path / "LATEST").read_text().strip() == "t"
    assert json.loads((run_dir / "summary.json").read_text()) == summary
    assert summary["schema_version"] == SCHEMA_VERSION == J.SCHEMA_VERSION
    assert summary["scenarios"] == ["stuck_knob", "crash_restore"]
    assert summary["seeds"] == [0, 1]
    assert summary["device"] == "cpu" and summary["all_ok"]
    arts = sorted(run_dir.glob("*--seed*.json"))
    assert len(arts) == len(summary["runs"]) == 4
    for path in arts:
        art = json.loads(path.read_text())
        assert art["schema_version"] == SCHEMA_VERSION
        assert art["run_id"] == "t" and art["device"] == "cpu"
        assert art["spec"] == MANIFEST["scenarios"][art["scenario"]]
        assert path.name == \
            f"{art['scenario']}--seed{art['seed']}--{art['impl']}.json"
        assert art["ok"] and all(g["pass"] for g in art["gates"].values())


def test_module_runs_as_a_program(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "--device", "cpu",
         "--only", "crash_restore", "--only", "transient_failures",
         "--seeds", "0", "--out", str(tmp_path), "--run-id", "cli"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "run cli: 2 runs, all_ok=True" in proc.stdout
    summary = json.loads((tmp_path / "cli" / "summary.json").read_text())
    assert summary["scenarios"] == ["transient_failures", "crash_restore"]


@pytest.mark.parametrize("only,item", [
    (["crash_restore", "elastic_shrink"], "A7"),
    (["elastic_shrink_midsession"], "A7"),
    (None, "A7"),                  # elastic_shrink comes first
], ids=["elastic_after_a_ported_one", "elastic_session", "all"])
def test_unported_kinds_raise_before_any_scenario(tmp_path, only, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        run_manifest(out_dir=tmp_path, run_id="x", only=only, device="cpu")
    assert not (tmp_path / "x").exists()        # nothing ran, nothing saved
    for name in ("elastic_shrink", "elastic_shrink_midsession"):
        with pytest.raises(NotImplementedError, match="does not run yet"):
            run_scenario(name, MANIFEST["scenarios"][name], device="cpu")


def test_smoke_subset_runs(tmp_path):
    """The manifest's smoke subset (its CI shape), ``fleet_transfer``
    among it, runs through and passes every gate."""
    summary = run_manifest(out_dir=tmp_path, run_id="s", smoke=True,
                           device="cpu")
    assert summary["scenarios"] == MANIFEST["smoke"]["scenarios"]
    assert "fleet_transfer" in summary["scenarios"]
    assert summary["seeds"] == MANIFEST["smoke"]["seeds"]
    assert summary["all_ok"] and len(summary["runs"]) == 4
    fleet = json.loads((tmp_path / "s" /
                        "fleet_transfer--seed0--auto.json").read_text())
    m = fleet["metrics"]
    assert m["tenants"] == 2 and m["warm_transfers"] >= 1
    assert m["monitor_dispatches"] >= m["windows"] // 2
