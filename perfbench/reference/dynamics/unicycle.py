"""The unicycle: x = (px, py, heading), u = (speed, turn rate)."""
import torch


def f(x, u, params):
    return torch.stack([u[..., 0] * torch.cos(x[..., 2]),
                        u[..., 0] * torch.sin(x[..., 2]),
                        u[..., 1]], dim=-1)
