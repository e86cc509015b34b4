"""Drivers: each runs one entry point of the port for the cells that
name it (portbench/workloads/<cell>.json `driver`)."""
