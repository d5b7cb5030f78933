"""Operational tooling (reference `src/cmd/tools/*`)."""
