"""Clients of the aggregator tier (reference `src/aggregator/client`)."""
