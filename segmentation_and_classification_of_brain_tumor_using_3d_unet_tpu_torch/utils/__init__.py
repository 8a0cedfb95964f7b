"""Host-side helpers: isosurfaces and the medical visualizer."""
