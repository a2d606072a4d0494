"""Tree models of the port: the binned engine, tree storage and GBM."""
