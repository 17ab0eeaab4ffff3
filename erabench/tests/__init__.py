"""CPU tests of the benchmark's harness, generator and reference."""
