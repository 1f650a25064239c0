"""Parallel encodes: the batched multi-clip encode over a (dp, sp) mesh
of devices, the segment-parallel encode over host processes, and the
multi-device dry run (mesh.py, dryrun.py); planes cut into tiles over
the mesh with explicit halos, and the encoder's and decoder's placement
hook (sharding.py)."""
