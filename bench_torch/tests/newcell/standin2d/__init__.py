"""A stand-in 2D program for the harness's tests (tests/test_new_cell.py),
which play it as the program package of a temporary copy of the benchmark.
Imports torch only."""
