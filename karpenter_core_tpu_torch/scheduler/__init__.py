"""The scheduler pieces the batched solve reads: the counting half of
the topology engine (``topology``: existing matching pods per domain,
which seed the solver's spread quotas) and the PVC zone pins
(``volumetopology``)."""
