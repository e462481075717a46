"""Run logs, model summaries, optional wandb logging and figures of the port
(counterpart of hybrid_vit_cascade_tpu/utils)."""
