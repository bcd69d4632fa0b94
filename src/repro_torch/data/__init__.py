"""Workload data for the port: the synthetic memory-dump families."""
