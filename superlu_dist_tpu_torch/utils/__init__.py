"""Host utilities: statistics, test matrices, the native host library."""
