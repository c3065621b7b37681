"""Weight conversion and random-number helpers."""
