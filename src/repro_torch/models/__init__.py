"""The model stack of the port: the decoder-only serving path of the
dense, VLM and MoE families, with GQA or MLA attention (``config``,
``layers``, ``lm``, ``api``), plain PyTorch.  Like the reference's models,
it calls no Pallas/CUDA kernel: attention is the plain
``layers.chunked_attention`` and the experts are plain einsums."""
