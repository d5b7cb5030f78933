"""Collection agent (reference `src/collector`)."""
