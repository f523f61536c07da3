"""Shard codec: block-quantized checkpoint payloads, opt-in per StateKind
(port of ``repro.core.codec``).

**Codec tags** (self-describing, recorded per shard in
``DistManifest.shard_codecs``):

================== =========================================================
``raw``            plain ``.npy`` shard (the default; absent from the table)
``int8:b<N>``      lossy block int8, block size N, per-block fp32 scales
``int8ef:b<N>``    int8 + persisted fp32 error-feedback residual — decodes
                   **bit-exact** (the encoder verifies the round trip and
                   falls back to ``raw`` if exactness cannot be proven)
``fp8:e4m3:b<N>``  lossy per-block-scaled float8_e4m3fn
``fp8:e5m2:b<N>``  lossy per-block-scaled float8_e5m2
================== =========================================================

**Digests.**  ``shard_digests`` records the *served* (decoded) content; for
lossy tags the *pre-encode* digest of the raw shard also lands in
``shard_pre_digests``.

**Payload container** (``RQS1``), byte-identical to the reference's::

    b"RQS1" | uint32le header_len | json.dumps(header) | q bytes | scales | [residual]

with the header keys in the order ``codec, dtype, shape, count, block,
sections``.

**Where the arithmetic runs.**  A shard that is a CUDA tensor is quantized
by the Hopper kernel and its decoded view dequantized there too
(:mod:`repro_torch.kernels.block_quant`); only q, the scales and what the
caller hashes go to the host.  :func:`decode_payload` with a CUDA
``device`` uploads q and the scales and decodes on the card.  Numpy arrays,
CPU tensors and a CPU ``device`` take the plain version of the same
wrappers.  ``int8ef``'s float64 residual and its verification run on the
host, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.kernels.block_quant.ops import block_dequantize, block_quantize
from repro_torch.kernels.block_quant.ref import QDTYPES

from .patterns import StateKind
from .tensor_io import EXTENDED_DTYPES, IntegrityError, array_nbytes, dtype_name, torch_dtype

__all__ = [
    "CODEC_RAW",
    "CodecPolicy",
    "CodecSpec",
    "EncodedShard",
    "decode_file",
    "decode_payload",
    "encode_shard",
    "parse_codec",
]

CODEC_RAW = "raw"

_MAGIC = b"RQS1"

# tag family -> quantized storage dtype name
_QDTYPES = {
    "int8": "int8",
    "int8ef": "int8",
    "fp8:e4m3": "float8_e4m3fn",
    "fp8:e5m2": "float8_e5m2",
}


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Parsed form of one codec tag."""

    family: str  # "raw" | "int8" | "int8ef" | "fp8:e4m3" | "fp8:e5m2"
    block: int = 256

    @property
    def tag(self) -> str:
        if self.family == CODEC_RAW:
            return CODEC_RAW
        return f"{self.family}:b{self.block}"

    @property
    def lossless(self) -> bool:
        """Whether decode is bit-exact (``int8ef`` by construction)."""
        return self.family in (CODEC_RAW, "int8ef")

    @property
    def qdtype(self) -> str:
        """Name of the quantized storage dtype."""
        return _QDTYPES[self.family]


def parse_codec(tag: str) -> CodecSpec:
    """Parse a self-describing codec tag; raises ``ValueError`` on junk."""
    if tag == CODEC_RAW:
        return CodecSpec(CODEC_RAW)
    for family in _QDTYPES:
        prefix = f"{family}:b"
        if tag.startswith(prefix):
            try:
                block = int(tag[len(prefix):])
            except ValueError:
                break
            if block <= 0:
                break
            return CodecSpec(family, block)
    raise ValueError(
        f"unrecognized codec tag {tag!r} (expected 'raw', 'int8:b<N>', "
        f"'int8ef:b<N>', 'fp8:e4m3:b<N>' or 'fp8:e5m2:b<N>')"
    )


@dataclasses.dataclass(frozen=True)
class CodecPolicy:
    """Per-StateKind precision policy.

    Params default to ``raw`` (restores must be bit-identical); optimizer
    moments are the lossy-tolerant state.  Lossy *params* require the
    explicit ``allow_lossy_params`` opt-in.
    """

    params: str = CODEC_RAW
    exp_avg: str = CODEC_RAW
    exp_avg_sq: str = CODEC_RAW
    allow_lossy_params: bool = False

    def __post_init__(self):
        for field in ("params", "exp_avg", "exp_avg_sq"):
            parse_codec(getattr(self, field))  # raises on junk
        if not parse_codec(self.params).lossless and not self.allow_lossy_params:
            raise ValueError(
                f"codec {self.params!r} for params is lossy; params must "
                "restore bit-identical (use 'raw' or 'int8ef:b<N>', or opt "
                "in explicitly with allow_lossy_params=True)"
            )

    @classmethod
    def moments(cls, tag: str = "int8:b256") -> "CodecPolicy":
        """The default lossy-tolerant policy: raw params, coded moments."""
        return cls(exp_avg=tag, exp_avg_sq=tag)

    def tag_for(self, kind: StateKind) -> str:
        if kind == StateKind.FP32:
            return self.params
        return getattr(self, kind.value)

    @property
    def is_raw(self) -> bool:
        return (
            self.params == CODEC_RAW
            and self.exp_avg == CODEC_RAW
            and self.exp_avg_sq == CODEC_RAW
        )


# --------------------------------------------------------------------- encode
@dataclasses.dataclass
class EncodedShard:
    """Result of encoding one shard.

    ``tag`` is what was *actually* written (``int8ef`` falls back to
    ``raw``); ``payload`` is the uint8 container (None for raw);
    ``decoded`` is exactly what a reader of the written bytes will see —
    on the input's device when the input is a tensor."""

    tag: str
    payload: np.ndarray | None
    decoded: np.ndarray | torch.Tensor


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 numpy view of a tensor's element bytes, on the host."""
    return t.detach().contiguous().view(torch.uint8).reshape(-1).cpu().numpy()


def encode_shard(arr, tag: str) -> EncodedShard:
    """Encode one raw shard (numpy array or tensor) under ``tag``.

    Lossy families return the payload and the decoded view.  ``int8ef``
    also persists an fp32 residual computed in float64 (``q·scale`` is
    exact there), verifies that the decode reproduces the input bit for
    bit, and falls back to ``raw`` when it does not.
    """
    spec = parse_codec(tag)
    if spec.family == CODEC_RAW:
        return EncodedShard(CODEC_RAW, None, arr)
    is_numpy = not isinstance(arr, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(arr)) if is_numpy else arr.detach()
    count = t.numel()
    q, scales = block_quantize(t, block=spec.block, dtype=spec.qdtype)
    q_bytes, s_host = _host_bytes(q), scales.cpu()
    sections: list[tuple[str, np.ndarray]] = [("q", q_bytes), ("scales", s_host.numpy())]
    if spec.family == "int8ef":
        x64 = t.cpu().to(torch.float64).reshape(-1)
        d64 = (q.cpu().to(torch.float64) * s_host.to(torch.float64)[:, None]).reshape(-1)[:count]
        residual = (x64 - d64).to(torch.float32)
        decoded = (d64 + residual.to(torch.float64)).to(t.dtype).reshape(t.shape)
        if not np.array_equal(_host_bytes(decoded), _host_bytes(t)):
            # exactness not provable for these values: refuse to pretend
            obs.event("codec.ef_fallback", nbytes=array_nbytes(t))
            return EncodedShard(CODEC_RAW, None, arr)
        sections.append(("residual", residual.numpy()))
        decoded = decoded.to(t.device)
    else:
        decoded = block_dequantize(q, scales, count=count).to(t.dtype).reshape(t.shape)
    if is_numpy:
        decoded = decoded.numpy()
    header = {
        "codec": spec.tag,
        "dtype": dtype_name(t.dtype),
        "shape": list(t.shape),
        "count": int(count),
        "block": int(spec.block),
        "sections": [[name, int(a.nbytes)] for name, a in sections],
    }
    hbytes = json.dumps(header).encode()
    payload = np.concatenate(
        [np.frombuffer(_MAGIC + struct.pack("<I", len(hbytes)) + hbytes, dtype=np.uint8)]
        + [np.ascontiguousarray(a).view(np.uint8).reshape(-1) for _, a in sections]
    )
    obs.add("codec.encode_shards")
    obs.add("codec.encode_bytes_raw", array_nbytes(t))
    obs.add("codec.encode_bytes_coded", int(payload.nbytes))
    return EncodedShard(spec.tag, payload, decoded)


# --------------------------------------------------------------------- decode
def decode_payload(
    buf: np.ndarray, *, expect_tag: str | None = None,
    expect_dtype: str | None = None, device=None,
):
    """Decode one ``RQS1`` payload → the served array.

    ``expect_tag`` / ``expect_dtype`` cross-check the payload's own header
    against the manifest; a mismatch is an :class:`IntegrityError`.  The
    lossy families decode through :func:`block_dequantize`: on the card
    with a CUDA ``device`` (a tensor there), else its plain version (a
    numpy array, or a CPU tensor for the dtypes numpy cannot hold)."""
    raw = np.asarray(buf, dtype=np.uint8).reshape(-1)
    if raw[:4].tobytes() != _MAGIC:
        raise IntegrityError(
            f"coded shard payload lacks the {_MAGIC!r} magic "
            "(manifest says coded, file says raw?)"
        )
    (hlen,) = struct.unpack("<I", raw[4:8].tobytes())
    header = json.loads(raw[8 : 8 + hlen].tobytes().decode())
    tag = header["codec"]
    if expect_tag is not None and tag != expect_tag:
        raise IntegrityError(
            f"coded shard header says {tag!r}, manifest recorded {expect_tag!r}"
        )
    if expect_dtype is not None and header["dtype"] != expect_dtype:
        raise IntegrityError(
            f"coded shard header dtype {header['dtype']!r} != "
            f"manifest dtype {expect_dtype!r}"
        )
    spec = parse_codec(tag)
    count = int(header["count"])
    nblocks = -(-count // spec.block)
    off = 8 + hlen
    parts: dict[str, np.ndarray] = {}
    for name, nbytes in header["sections"]:
        parts[name] = raw[off : off + nbytes]
        off += nbytes
    qdt = QDTYPES[spec.qdtype]
    dt = header["dtype"]
    shape = header["shape"]
    on_card = device is not None and torch.device(device).type == "cuda"
    dev = torch.device(device) if on_card else torch.device("cpu")
    q = torch.from_numpy(np.array(parts["q"])).view(qdt).reshape(nblocks, spec.block)
    scales = torch.from_numpy(np.array(parts["scales"].view(np.float32)))
    if spec.family == "int8ef":
        # float64 residual path, on the host as in the reference
        residual = torch.from_numpy(np.array(parts["residual"].view(np.float32)))
        d64 = (q.to(torch.float64) * scales.to(torch.float64)[:, None]).reshape(-1)[:count]
        out = (d64 + residual.to(torch.float64)).to(torch_dtype(dt)).to(dev)
    else:
        out = block_dequantize(q.to(dev), scales.to(dev), count=count).to(torch_dtype(dt))
    out = out.reshape(shape)
    obs.add("codec.decode_shards")
    obs.add("codec.decode_bytes", array_nbytes(out))
    if not on_card and dt not in EXTENDED_DTYPES:
        return out.numpy()
    return out


def decode_file(path, tag: str, *, dtype: str | None = None, device=None):
    """Load and decode one coded shard file (the ``read_shard`` loader leg)."""
    buf = np.load(path, mmap_mode="r")
    return decode_payload(buf, expect_tag=tag, expect_dtype=dtype, device=device)
