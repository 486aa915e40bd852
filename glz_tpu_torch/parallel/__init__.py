"""The codec across devices and processes: the device mesh (mesh.py), the
multi-process paths (multihost.py), the rank spawner they are tested and
dry-run with (ranks.py) and the entry points (dryrun.py)."""
