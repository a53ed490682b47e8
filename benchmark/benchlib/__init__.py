"""The benchmark harness: manifest, inputs, weights, session, trace, check."""
