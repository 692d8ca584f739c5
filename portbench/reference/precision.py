"""The precision of the reference: float32 with TF32 off; or, for the
control, float8 e4m3 (the precision below the configuration's bfloat16)
with one scale per tensor wherever the program keeps bfloat16: each
product's operands and result, and the residual stream and embeddings
(``act``); products still accumulate in float32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 at a per-tensor scale; the gradient
    passes straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Products:
    """``mm(a, b)``: a product in the reference's precision (``fp8=False``)
    or the control's (``fp8=True``); ``act(x)``: an activation stored in
    it."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor,
           wide_out: bool = False) -> torch.Tensor:
        """``wide_out``: a result the program keeps in float32 (the
        attention scores)."""
        if not self.fp8:
            return torch.matmul(a, b)
        out = torch.matmul(_fp8(a), _fp8(b))
        return out if wide_out else _fp8(out)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.fp8 else x
