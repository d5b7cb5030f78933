"""PromQL comparator: the port's engine against an independent naive oracle."""
