# repro: scope(float-dtype)
"""Fixture: torch's forms of the float-dtype violations, each marked, and
the explicit forms that must NOT fire."""
import torch


def casts(x):
    a = x.to(torch.float32)  # VIOLATION: f32 on an f64 path
    b = x.to(torch.float)  # VIOLATION: torch.float is float32
    c = x.to(torch.half)  # VIOLATION
    d = x.to(torch.float16)  # VIOLATION
    e = x.to(torch.bfloat16)  # VIOLATION
    return a, b, c, d, e


def fills(n):
    a = torch.zeros(n)  # VIOLATION: torch's default dtype, float32
    b = torch.ones(n, 2)  # VIOLATION
    c = torch.empty((n,))  # VIOLATION
    d = torch.full((n,), 0.5)  # VIOLATION: a float fill is float32
    return a, b, c, d


def explicit_ok(n, x):
    a = torch.zeros(n, dtype=torch.float64)
    b = torch.empty(n, dtype=torch.bool)
    c = torch.full((n,), 0.0, dtype=torch.float64, device=x.device)
    d = torch.ones(n, 2, dtype=torch.int64)
    e = torch.zeros_like(x)  # inherits the input's dtype
    return a, b, c, d, e, x.to(torch.float64)
