"""Configuration dataclasses of the port.

``ModelConfig`` mirrors ``gnot_tpu/config.py::ModelConfig`` field for
field, with the same defaults and the same refusals. ``DataConfig`` and
``ServeConfig`` keep only the fields ``datasets.load`` and the serving
path read.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GNOT architecture hyperparameters (reference main.py:16-22)."""

    input_dim: int = 2
    theta_dim: int = 1
    input_func_dim: int = 1
    out_dim: int = 1
    n_input_functions: int = 1
    n_attn_layers: int = 4
    n_attn_hidden_dim: int = 256
    n_mlp_num_layers: int = 4
    n_mlp_hidden_dim: int = 256
    n_input_hidden_dim: int = 256
    n_expert: int = 3
    n_head: int = 8
    # "parity": unmasked padding, pollution-faithful to the reference.
    # "masked": correct masking; results independent of pad lengths.
    attention_mode: str = "masked"
    # "xla" is the only attention impl: the fused attention kernel lost
    # the A/B against the einsum path and its model dispatch was
    # retired. The name is kept so configs read the same in both
    # packages; here "xla" means the plain torch einsum path.
    attention_impl: str = "xla"
    # "xla": batched-matmul expert FFN in plain torch. "pallas": the
    # fused gated-FFN kernel (ops/fused_ffn.py, csrc/fused_gated_ffn.cu).
    ffn_impl: str = "xla"
    # GELU flavor for every MLP: "erf" (torch nn.GELU default, the
    # reference's op) or "tanh". "" resolves to "erf" in parity mode
    # and "tanh" otherwise.
    gelu: str = ""
    dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = False

    def __post_init__(self) -> None:
        if self.n_attn_hidden_dim % self.n_head:
            raise ValueError("n_attn_hidden_dim must be divisible by n_head")
        if self.attention_mode not in ("parity", "masked"):
            raise ValueError(f"unknown attention_mode {self.attention_mode!r}")
        if not self.gelu:
            object.__setattr__(
                self,
                "gelu",
                "erf" if self.attention_mode == "parity" else "tanh",
            )
        if self.gelu not in ("erf", "tanh"):
            raise ValueError(f"unknown gelu {self.gelu!r}")
        if self.attention_mode == "parity" and self.gelu != "erf":
            raise ValueError(
                "parity mode reproduces the reference bit-for-bit and "
                "requires gelu='erf' (torch nn.GELU); tanh-GELU is the "
                "masked-mode TPU default"
            )
        if self.attention_impl == "pallas":
            raise ValueError(
                "attention_impl='pallas' was retired in round 4: the "
                "fused kernel measured slower than the XLA einsum path "
                "at every scale under honest timing (docs/performance.md"
                " 'Why the fused attention kernel lost'). The kernels "
                "remain in ops/pallas_attention.py for research use."
            )
        if self.attention_impl != "xla":
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.ffn_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown ffn_impl {self.ffn_impl!r}")
        if self.scan_layers and (
            self.attention_impl != "xla" or self.ffn_impl != "xla"
        ):
            raise ValueError("scan_layers requires the xla attention/ffn impls")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The data fields ``datasets.load`` and the serving path read
    (``gnot_tpu`` DataConfig)."""

    train_path: str = ""
    test_path: str = ""
    synthetic: str = "ns2d"  # darcy2d | ns2d | elasticity | inductor2d | heatsink3d
    # Size knob of the synthetic generator (0 = its default): grid side
    # for darcy2d (points = size^2), mesh points for the others.
    synth_size: int = 0
    n_train: int = 64
    n_test: int = 16
    batch_size: int = 4
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving policies the port implements (``gnot_tpu`` ServeConfig)."""

    # A bucket's queue flushes at max_batch requests or when its oldest
    # request has waited max_wait_ms; every dispatch is padded to
    # max_batch rows, so each bucket has one dispatch shape.
    max_batch: int = 4
    max_wait_ms: float = 10.0
    # At most queue_limit requests in the system; beyond it submissions
    # fast-fail ("shed_queue_full").
    queue_limit: int = 64

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}"
            )
        if self.queue_limit < 1:
            raise ValueError(
                f"queue_limit must be >= 1, got {self.queue_limit}"
            )
