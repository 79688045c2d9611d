"""Workload generation: the YCSB-style op streams and value shapes
(``workload.ycsb``) and the client op mix (``workload.openloop``)."""
