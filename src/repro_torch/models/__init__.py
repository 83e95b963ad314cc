"""The model stack of the port: the decoder-only serving path of the
dense and VLM families (``config``, ``layers``, ``lm``, ``api``), plain
PyTorch.  Like the reference's models, it calls no Pallas/CUDA kernel:
attention is the plain ``layers.chunked_attention``."""
