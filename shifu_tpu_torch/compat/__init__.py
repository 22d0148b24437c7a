"""Reference (DevinWu/shifu) model-spec format compatibility (counterpart
of `shifu_tpu/compat/`).

Readers/writers for the reference's on-disk model formats so models trained
by either framework score identically in the other:

* :mod:`shifu_tpu_torch.compat.encog`    — Encog EG text ``.nn`` (BasicNetwork)
* :mod:`shifu_tpu_torch.compat.egb`      — BinaryNNSerializer gzip ``.nn``
* :mod:`shifu_tpu_torch.compat.treespec` — BinaryDTSerializer ``.gbt``/``.rf`` + zip
* :mod:`shifu_tpu_torch.compat.wdl`      — BinaryWDLSerializer gzip ``.wdl``
* :mod:`shifu_tpu_torch.compat.javaio`   — java.io.Data{Input,Output}Stream wire format
"""

from shifu_tpu_torch.compat import egb, encog, javaio, treespec  # noqa: F401


def sniff_model_format(data: bytes) -> str:
    """Classify model-file bytes: 'eg-text', 'ref-binary' (gzip Java stream),
    'zip', or 'native' (the `STNN`/`STDT`/`STWD` specs)."""
    if data[:6] == b"encog,":
        return "eg-text"
    if data[:2] == b"\x1f\x8b":
        return "ref-binary"
    if data[:2] == b"PK":
        return "zip"
    return "native"
