"""Launchers of the port: the train entry point (``train``).  The mesh
and the multi-pod dry run are not ported yet (ROADMAP item 13b)."""
