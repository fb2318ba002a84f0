"""Multi-GPU training: the process group (multihost.py), the data x fsdp
mesh with FSDP2 and per-process batch rows (mesh.py), and the dry run
(dryrun.py). Tensor parallelism (the mesh's model axis) is not ported."""
