"""Data-parallel training over several cards (counterpart of
hybrid_vit_cascade_tpu/parallel): one process per card, NCCL collectives on
the card and gloo on the CPU. The data axis only; ``mesh.py`` says what is
not ported."""
