"""Data parallelism over several devices (parallel/mesh.py) and several
processes (parallel/multihost.py), with a dry run (parallel/dryrun.py)."""
