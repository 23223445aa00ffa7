"""The harness's own parts: the manifest, the traffic generator, the
seeded weights, the peaks, the trace reader and the comparison."""
