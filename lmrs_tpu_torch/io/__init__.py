"""Model file reading, writing and parameter loading."""
