"""Data ingest of the port."""
