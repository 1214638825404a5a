"""Tools that set the benchmark's limits and bounds on the card; the runs
of the benchmark itself never call them."""
