"""Serving: the traffic generator's scenarios (the serving pipeline is not
ported yet)."""
