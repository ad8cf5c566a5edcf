"""The benchmark's harness: reading the cell, the system under test, the
clients, the trace and the comparison that decides ``correct``."""
