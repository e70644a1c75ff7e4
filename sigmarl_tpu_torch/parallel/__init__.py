"""Data parallelism over ranks: the env axis sharded with
`torch.distributed` (`mesh.py`) and a multi-rank dry run (`dryrun.py`)."""
