"""Host-side data of the port (counterpart of hybrid_vit_cascade_tpu/data):
numpy datasets, NIfTI IO and an epoch loader; torch only at the copy to
the device."""
