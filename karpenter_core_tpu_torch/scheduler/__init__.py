"""The counting half of the topology engine (``topology``): existing
matching pods per domain, which seed the solver's spread quotas."""
