"""Content generators, one a file, each found by the ``content`` name of a
traffic mix."""
