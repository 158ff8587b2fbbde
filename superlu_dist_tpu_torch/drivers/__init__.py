"""Command-line drivers (EXAMPLE/pddrive*.c and TEST/pdtest.c analogs)."""
