"""Parallel encodes: the batched multi-clip encode over a mesh of
devices, the segment-parallel encode over host processes, and the
multi-device dry run (mesh.py, dryrun.py)."""
