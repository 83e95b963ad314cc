"""K5: flash attention (replaces ``repro.kernels.flash.flash_attention``)."""
