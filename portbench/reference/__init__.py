"""The plain reference the benchmark judges the port against.

Plain PyTorch over a dict of fp32 tensors named as the OpenAI CLIP and
CLIP-ReID state dicts name them (``image_encoder.transformer.resblocks.0.
attn.in_proj_weight`` and so on), written from the published layer
equations: it imports nothing of the port (``mpreid_tpu_torch``) and
nothing of the JAX package. Every product runs through ``precision.Precision``:
fp32 with TF32 off (the reference), or with both operands of every product
rounded to scaled fp8 e4m3 forward and backward (the control).
"""
