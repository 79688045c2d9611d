"""Workload generation: the YCSB-style op streams (``workload.ycsb``)."""
