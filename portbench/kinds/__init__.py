"""The traffic generators, one module per kind, found by the ``kind`` of
a mix in ``portbench/traffic/<mix>.json``."""
