"""Scalable packed layouts in PyTorch: the hardware query, tile functions,
pack/unpack, mmt4d, packed-domain ops and the model-facing linear layer."""
