"""Correctness gate of the port: history recording + linearizability
checking (copies of ``hermes_tpu/checker``)."""
