"""The general runner of ``portbench``: finds a cell's files by name,
draws its traffic from the seed, drives the program, reads the trace and
decides ``correct``."""
