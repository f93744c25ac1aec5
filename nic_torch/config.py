"""Typed config with ``KEY=VALUE`` CLI overrides (port of ``nic.config``).

The same UPPERCASE keys and defaults as the JAX package (the reference's
var2 flags), parsed into a frozen dataclass. Differences from the JAX copy:

- ``compute_dtype()`` returns the dot-input type: 16 is the surgical mode
  (bf16 dot inputs, fp32 sums and everything else fp32), 32 is fp32;
- ``TRAIN_FORWARD=auto`` resolves to ``kernel3`` on a CUDA device (the
  trainer then falls back LOD by LOD to kernel2 and kernel through the
  JAX gates) and to ``gather`` on the CPU, and ``DECODE_BACKEND=auto`` to
  the CUDA decode
  kernel (``pallas``, the JAX name of the fused backend) on a CUDA device
  and to ``fast`` on the CPU;
- one new key, ``DEVICE`` (``cuda`` by default, which raises without a
  card; ``cpu`` must be asked for).

Keys accepted without effect: ``SDC_GUARD_TRAIN`` (the in-train SDC probe
guards a TPU tunnel the port does not run through), ``RNG_IMPL`` (the port
draws from ``torch.Generator``), ``GRID_VJP`` (both values take autograd's
gradient, which equals both JAX paths' values).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

__all__ = ["CompressionConfig", "parse_overrides", "config_echo"]


def _parse_bool(value: str, key: str) -> bool:
    v = value.lower()
    if v in ("true", "1"):
        return True
    if v in ("false", "0"):
        return False
    raise ValueError(f"{key} must be a boolean (True/False or 1/0)")


@dataclass(frozen=True)
class CompressionConfig:
    """Flags of the flagship ``image_compression`` workload; defaults are
    the JAX package's (``nic/config.py``)."""

    image_path: str = "data/sancho_512.png"
    project_name: str = "image_compression"
    compression_method: int = 1  # 1: 2D | 2: 3D→2D tiles | 3: 3D | 4: sparse-G0 3D
    mlp_num_dtype: int = 16      # 16: surgical bf16 dot inputs | 32: fp32
    num_epochs: int = 1000
    uniform_distribution_rate: float = 0.05
    image_3d_size: int = 64
    image_size: int = 512
    image_size_w: int = 0
    image_dimension: int = 2
    max_mip_level: int = 9
    image_bits: int = 8
    output_bits: int = 8
    feature_pyramid_channels: int = 12
    pe_channels: int = 6
    fp_bits: int = 8
    hidden_layer_channels: int = 64
    crop_mip_level: int = 8
    num_crops: int = 8
    interval_print: int = 100
    interval_save_model: int = 100000
    tf_no_mip: bool = True
    tf_use_tri_pe: bool = True
    tf_train_model: bool = True
    tf_show_result: bool = False
    tf_print_log: bool = True
    tf_print_psnr: bool = True
    tf_write_time: bool = True
    tf_write_psnr: bool = True
    seed: int = 0
    decode_backend: str = "auto"     # auto | fast | pallas (the CUDA kernel) | xla
    qat_ste: bool = False
    data_parallel: bool = False
    output_root: str = "runs"
    save_lut_csv: bool = False
    rng_impl: str = "rbg"            # accepted, no effect (torch.Generator)
    tf_g1_quirk: bool = True
    mlp_store_bits: int = 32
    entropy_code_grids: bool = False
    tf_resume: bool = False
    sdc_guard_train: bool = True     # accepted, no effect (no SDC probe)
    train_forward: str = "auto"      # auto | gather | kernel3 | kernel2 |
                                     # kernel | folded
    train_gelu: str = "poly"         # GELU inside the train kernels: poly | erf
    grid_vjp: str = "scatter"        # scatter | dense: both autograd here
    qat_noise_where: str = "feature"  # feature | node
    div_size: int = 10
    profile_dir: str = ""
    device: str = "cuda"             # cuda | cpu (the port's own key)

    # ---- derived ----

    def torch_device(self) -> torch.device:
        """The device the run uses; ``cuda`` without a card raises."""
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"DEVICE must be cuda or cpu, not {self.device!r}")
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DEVICE=cuda: no CUDA device is available "
                               "(pass DEVICE=cpu to run on the CPU)")
        return torch.device(self.device)

    def resolved_train_forward(self, device: torch.device) -> str:
        """``auto`` → ``kernel3`` on a CUDA device, ``gather`` on the CPU
        (the JAX package's TPU/elsewhere split, nic/train/ntc.py:236)."""
        if self.train_forward != "auto":
            return self.train_forward
        return "kernel3" if torch.device(device).type == "cuda" else "gather"

    def resolved_decode_backend(self, device: torch.device) -> str:
        """``auto`` → ``pallas`` (the CUDA decode kernel) on a CUDA device,
        ``fast`` (the folded first layer) on the CPU."""
        if self.decode_backend != "auto":
            return self.decode_backend
        return "pallas" if torch.device(device).type == "cuda" else "fast"

    @property
    def basename(self) -> str:
        return os.path.basename(self.image_path)

    @property
    def feature_pyramid_size(self) -> int:
        return self.image_size // 4

    @property
    def image_hw(self) -> tuple[int, int]:
        return (self.image_size, self.image_size_w or self.image_size)

    @property
    def is_rectangular(self) -> bool:
        return self.image_size_w not in (0, self.image_size)

    @property
    def feature_pyramid_hw(self) -> tuple[int, int]:
        h, w = self.image_hw
        return (h // 4, w // 4)

    @property
    def fp_dimension(self) -> int:
        return 2 if self.compression_method == 2 else self.image_dimension

    @property
    def effective_max_mip_level(self) -> int:
        return 0 if self.tf_no_mip else self.max_mip_level

    @property
    def decoder_input_channels(self) -> int:
        """C·(2^dim + 1) + PE·dim + 1 (method 4: C·(4 + 1) + ...)."""
        c, pe, dim = (self.feature_pyramid_channels, self.pe_channels,
                      self.fp_dimension)
        g0_corners = 4 if self.compression_method == 4 else 2**dim
        return c * (g0_corners + 1) + pe * dim + 1

    @property
    def crop_size(self) -> int:
        return 2**self.crop_mip_level

    @property
    def save_name(self) -> str:
        """Artifact stem, the JAX package's scheme (device name 'tpu' kept
        so both packages name a run's files alike)."""
        return (
            f"{self.project_name}_tpu_{self.basename}_{self.mlp_num_dtype}_"
            f"{self.tf_no_mip}_{self.tf_use_tri_pe}_{self.compression_method}_"
            f"{self.num_epochs}_{self.fp_bits}"
        )

    def compute_dtype(self) -> torch.dtype:
        """Dot-input type: 16 → bf16 (surgical), 32 → fp32."""
        try:
            return {16: torch.bfloat16, 32: torch.float32}[self.mlp_num_dtype]
        except KeyError:
            raise ValueError(f"MLP_NUM_DTYPE must be 16 or 32, not "
                             f"{self.mlp_num_dtype}") from None


# CLI key → dataclass field (the JAX package's whitelist plus DEVICE)
_CLI_KEYS: dict[str, str] = {
    "FP_BITS": "fp_bits",
    "NUM_EPOCHS": "num_epochs",
    "IMAGE_SIZE": "image_size",
    "IMAGE_SIZE_W": "image_size_w",
    "IMAGE_3D_SIZE": "image_3d_size",
    "MAX_MIP_LEVEL": "max_mip_level",
    "FEATURE_PYRAMID_CHANNELS": "feature_pyramid_channels",
    "PE_CHANNELS": "pe_channels",
    "IMAGE_PATH": "image_path",
    "PROJECT_NAME": "project_name",
    "COMPRESSION_METHOD": "compression_method",
    "MLP_NUM_DTYPE": "mlp_num_dtype",
    "UNIFORM_DISTRIBUTION_RATE": "uniform_distribution_rate",
    "IMAGE_DIMENSION": "image_dimension",
    "IMAGE_BITS": "image_bits",
    "OUTPUT_BITS": "output_bits",
    "HIDDEN_LAYER_CHANNELS": "hidden_layer_channels",
    "CROP_MIP_LEVEL": "crop_mip_level",
    "NUM_CROPS": "num_crops",
    "INTERVAL_PRINT": "interval_print",
    "INTERVAL_SAVE_MODEL": "interval_save_model",
    "TF_NO_MIP": "tf_no_mip",
    "TF_USE_TRI_PE": "tf_use_tri_pe",
    "TF_TRAIN_MODEL": "tf_train_model",
    "TF_SHOW_RESULT": "tf_show_result",
    "TF_PRINT_LOG": "tf_print_log",
    "TF_PRINT_PSNR": "tf_print_psnr",
    "TF_WRITE_TIME": "tf_write_time",
    "TF_WRITE_PSNR": "tf_write_psnr",
    "SEED": "seed",
    "DECODE_BACKEND": "decode_backend",
    "QAT_STE": "qat_ste",
    "DATA_PARALLEL": "data_parallel",
    "OUTPUT_ROOT": "output_root",
    "SAVE_LUT_CSV": "save_lut_csv",
    "RNG_IMPL": "rng_impl",
    "TF_G1_QUIRK": "tf_g1_quirk",
    "MLP_STORE_BITS": "mlp_store_bits",
    "ENTROPY_CODE_GRIDS": "entropy_code_grids",
    "TF_RESUME": "tf_resume",
    "SDC_GUARD_TRAIN": "sdc_guard_train",
    "DIV_SIZE": "div_size",
    "TRAIN_FORWARD": "train_forward",
    "GRID_VJP": "grid_vjp",
    "TRAIN_GELU": "train_gelu",
    "QAT_NOISE_WHERE": "qat_noise_where",
    "PROFILE_DIR": "profile_dir",
    "DEVICE": "device",
}


def parse_overrides(argv: list[str],
                    base: CompressionConfig | None = None) -> CompressionConfig:
    """Apply ``KEY=VALUE`` overrides; unknown keys raise."""
    cfg = base or CompressionConfig()
    fields = {f.name: f for f in dataclasses.fields(CompressionConfig)}
    updates: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"expected KEY=VALUE, got {arg!r}")
        key, value = arg.split("=", 1)
        field_name = _CLI_KEYS.get(key, key if key in fields else None)
        if field_name is None:
            raise ValueError(f"unknown config key {key!r}")
        ftype = fields[field_name].type
        if ftype in ("bool", bool):
            updates[field_name] = _parse_bool(value, key)
        elif ftype in ("int", int):
            updates[field_name] = int(value)
        elif ftype in ("float", float):
            updates[field_name] = float(value)
        else:
            updates[field_name] = value
    return dataclasses.replace(cfg, **updates)


def config_echo(cfg: CompressionConfig) -> list[str]:
    """``KEY : value`` lines, one per CLI key."""
    return [f"{key} : {getattr(cfg, name)}" for key, name in _CLI_KEYS.items()]
