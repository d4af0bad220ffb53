"""Meshes and device placement (the port's ``repro.launch``): ``mesh`` builds
``torch.distributed`` device meshes on an initialised process group and
assigns the serving engine's worker pools to cards; ``reshard`` re-lays-out
the training state across ranks for a re-planned theta*; ``fleet`` keeps the
host roster an elastic run recovers over."""
