"""Frame/Vec store and key-value registry of the port."""
