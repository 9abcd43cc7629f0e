"""repro_torch.scenarios — manifest-driven chaos scenario harness.

Port of ``repro/scenarios``.  Sweeps seeds x scenarios x impl backends
through ``KermitSession`` on one device, with faults injected at the
Execute boundary (``repro_torch.kermit.chaos``), writing a schema-versioned
JSON artifact per run under ``results/<RUN_ID>/`` plus a summary index.

    python -m repro_torch.scenarios --device cpu --only crash_restore

See ``runner.run_manifest``.
"""
from repro_torch.scenarios.runner import (SCHEMA_VERSION, UNPORTED_KINDS,
                                          load_manifest, run_manifest,
                                          run_scenario)

__all__ = ["SCHEMA_VERSION", "UNPORTED_KINDS", "load_manifest",
           "run_manifest", "run_scenario"]
