"""The benchmark's yardstick: inputs, weights, work counts, trace reading."""
