"""The distribution layer of the port (port of ``repro.dist``).

* :mod:`repro_torch.dist.sharding` — the sharding rule table (UCP half).
* :mod:`repro_torch.dist.collectives` — compressed gradient collectives
  (block-wise int8 quantization with error feedback) over a
  ``torch.distributed`` process group.
"""

from .collectives import compressed_psum, dequantize_int8, quantize_int8

__all__ = ["compressed_psum", "dequantize_int8", "quantize_int8"]
