"""Destructive-test harness (reference `src/m3em` + `src/cmd/tools/dtest`).
The port's counterpart of ``m3_tpu/dtest``."""
