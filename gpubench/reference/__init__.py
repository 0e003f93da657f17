"""Plain reference of the FET and CSS scans (torch and numpy only)."""
