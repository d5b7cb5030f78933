"""Rules management service (reference `src/ctl` — r2)."""
