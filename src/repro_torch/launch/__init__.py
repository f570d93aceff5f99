"""Launchers of the port: device meshes (``mesh``) and the train entry
point (``train``).  The multi-pod dry run is not ported yet (ROADMAP
item 13c)."""
