"""The model stack of the port.  Ported so far: the attention core of
``models/layers.py`` (``chunked_attention``, ``repeat_kv``), plain
PyTorch."""
