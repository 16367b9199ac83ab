"""Traffic drivers: one general generator per kind of traffic, named by a
traffic file's ``driver``."""
