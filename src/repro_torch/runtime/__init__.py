"""Runtime services of the port: the in-band integrity guard."""
