"""
Stereo parameters
=================

The seven user-facing stereo tuning parameters. Field names, defaults, and
semantics are interface-compatible with the reference implementation
(reference helper/stereo_core.py:193-202); the compute that consumes
them lives in ``vsc_tpu_torch.ops.stereo``.

The dataclass is frozen so instances are hashable and can be passed as a
*static* argument to ``jax.jit`` — each distinct parameter set compiles once
(shapes downstream of the pre-stretch depend on the parameter values, so they
must be trace-time constants on TPU).
"""

from __future__ import annotations

from dataclasses import dataclass, asdict


@dataclass(frozen=True)
class StereoParams:
    """Parameters for stereo SBS generation.

    max_disparity      Maximum horizontal pixel shift for the nearest depth.
    convergence        Screen-plane placement; + pops out, - recedes.
    super_sampling     Warp-resolution multiplier (quality vs speed).
    edge_softness      Gaussian sigma applied to the depth map pre-warp.
    artifact_smoothing Bilateral-filter strength applied to each warped eye.
    depth_gamma        Gamma on normalized depth (<1 pulls mids nearer).
    sharpen            Unsharp-mask strength applied before downscale.
    """

    max_disparity: float = 50.0
    convergence: float = -10.0
    super_sampling: float = 3.0
    edge_softness: float = 20.0
    artifact_smoothing: float = 1.0
    depth_gamma: float = 0.2
    sharpen: float = 14.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_config(cls, stereo_config: dict) -> "StereoParams":
        """Build from the ``stereo`` section of a workflow config
        (field set mirrors reference sbs_generator.py:165-173)."""
        return cls(
            max_disparity=float(stereo_config["max_disparity"]),
            convergence=float(stereo_config["convergence"]),
            super_sampling=float(stereo_config["super_sampling"]),
            edge_softness=float(stereo_config["edge_softness"]),
            artifact_smoothing=float(stereo_config["artifact_smoothing"]),
            depth_gamma=float(stereo_config["depth_gamma"]),
            sharpen=float(stereo_config["sharpen"]),
        )
