"""Models of the port (LightGCN first; the rest of the zoo follows)."""
