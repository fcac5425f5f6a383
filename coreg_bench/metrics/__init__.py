"""One reader per metric, found by name (coreg_bench.discover)."""
