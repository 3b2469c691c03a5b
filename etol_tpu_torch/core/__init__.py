"""Problem data, geometry and shared types."""
