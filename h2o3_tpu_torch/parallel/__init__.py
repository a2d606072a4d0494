"""Device selection of the port (one device, no mesh in this slice)."""
