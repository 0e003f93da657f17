"""Tests of the benchmark, on the CPU at small sizes: ``python -m pytest
gpubench/tests``.  The ``gpu``-marked test runs the command on a card."""
