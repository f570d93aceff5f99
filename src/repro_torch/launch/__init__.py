"""Launchers of the port: device meshes (``mesh``), the train entry
point (``train``) and the multi-pod dry run (``dryrun``: every (arch x
shape) cell on ``meta`` tensors over a fake process group of 256 or 512
ranks, counted for the roofline)."""
