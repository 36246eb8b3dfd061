"""`assert_close` for the port's tests: torch.testing.assert_close's checks
(the same shape, dtype and device, then every element within
atol + rtol |expected| by `torch.isclose`, NaN unequal, with torch's default
tolerances per dtype when neither is given) without the SymPy import that
torch.testing pulls in on its first call (~1.3 s of every test process
that calls it)."""

import torch

# torch.testing's defaults: (rtol, atol) by dtype; exact for the others
DEFAULT_TOL = {torch.float16: (1e-3, 1e-5), torch.bfloat16: (1.6e-2, 1e-5), torch.float32: (1.3e-6, 1e-5),
               torch.float64: (1e-7, 1e-7), torch.complex64: (1.3e-6, 1e-5), torch.complex128: (1e-7, 1e-7)}


def assert_close(actual: torch.Tensor, expected: torch.Tensor, *, rtol: float | None = None,
                 atol: float | None = None, msg: str | None = None) -> None:
    if (rtol is None) != (atol is None):
        raise ValueError("give both rtol and atol, or neither")
    what = f"{msg}: " if msg else ""
    for name in ("shape", "dtype", "device"):
        a, e = getattr(actual, name), getattr(expected, name)
        if a != e:
            raise AssertionError(f"{what}{name} {a} != {e}")
    if rtol is None:
        rtol, atol = DEFAULT_TOL.get(actual.dtype, (0.0, 0.0))
    if actual.is_floating_point() or actual.is_complex():
        ok = torch.isclose(actual, expected, rtol=rtol, atol=atol)
    else:
        ok = actual == expected
    if not bool(ok.all()):
        diff = (actual.double() - expected.double()).abs()
        raise AssertionError(f"{what}{int((~ok).sum())} of {ok.numel()} elements beyond atol {atol} + rtol {rtol}; "
                             f"greatest absolute difference {float(diff[~ok].max())}")
