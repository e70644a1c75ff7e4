"""What every cell of the benchmark shares: the import guard, the card,
seeded weights, spans, the profiler window and the comparisons."""
