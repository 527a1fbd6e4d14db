"""The benchmark's machinery: finding a cell's files by name, generating
its traffic, running it, reading the profiler's trace, and judging the
proofs with the reference."""
