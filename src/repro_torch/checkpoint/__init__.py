"""repro_torch.checkpoint — atomic directory snapshots (:mod:`.atomic`):
tmp + fsync + rename and retention GC, shared by the mining snapshot store
and the training ``CheckpointManager`` (:mod:`.ckpt`)."""
