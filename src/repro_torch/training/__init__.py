"""repro_torch.training — the LM scaffold's training path on one device: AdamW
(:mod:`.optim`), gradient compression (:mod:`.compress`), the train step
(:mod:`.step`) and the loop with checkpoints and restarts (:mod:`.trainer`).
The reference's GPipe schedule (``training/pipeline.py``) needs a mesh and
is not ported yet."""
