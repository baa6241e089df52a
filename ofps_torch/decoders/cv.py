"""Dense-optical-flow decoder ("cv"): flow computed on the device from
decoded frames (port of ``ofps_tpu.decoders.cv``).

Frames decode on the host (:mod:`ofps_torch.decoders.av`); on the device,
:class:`CvFlowStep` computes dense flow from the previous frame, warm
started from the previous field, masks low-contrast regions (Sobel mixed
derivative -> threshold -> disk dilation, on the previous frame) and
densifies the masked flow into a <= 150 cell grid that keeps the aspect.
Two flow algorithms: ``use_rlof=False`` runs the SAD block-matching pyramid
(:func:`ofps_torch.ops.flow_pyramid.dense_flow`), ``use_rlof=True`` the
robust dense LK (:func:`ofps_torch.ops.flow_lk.dense_flow_lk`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ofps_torch.core.motion import _axis_scatter_matrix, grid_size_for
from ofps_torch.decoders.base import DecodedFrame, register
from ofps_torch.device import resolve_device
from ofps_torch.ops.flow_lk import LKParams, dense_flow_lk
from ofps_torch.ops.flow_pyramid import FlowParams, dense_flow
from ofps_torch.ops.image import dilate_disk, rgb_to_gray, sobel_xy


class CvFlowStep:
    """One decoder step on ``device``: ``(prev_gray, gray, prev_flow) ->
    (flow, grid, valid)``.

    ``prev_gray``, ``gray``: (..., H, W) float32; ``prev_flow``: (..., H,
    W, 2) warm start in pixels.  Returns the dense ``flow`` (..., H, W, 2),
    the mask-weighted cell means ``grid`` (..., gh, gw, 2) in normalized
    units and ``valid`` (..., gh, gw), the cells holding any masked-in
    pixel.  ``plain=True`` runs the kernels' plain versions on any device.
    """

    def __init__(
        self,
        height: int,
        width: int,
        grid_max_dim: int = 150,
        use_contrast_mask: bool = True,
        levels: int = 5,
        mask_threshold: float = 20.0,
        mask_dilate: int = 2,
        use_rlof: bool = False,
        device="cuda",
        plain: bool = False,
    ):
        self.device = resolve_device(device)
        self.shape = (height, width)
        self.grid_wh = grid_size_for(width, height, grid_max_dim)
        gw, gh = self.grid_wh
        self._sy = _axis_scatter_matrix(height, gh, self.device)  # (H, gh)
        self._sx = _axis_scatter_matrix(width, gw, self.device)  # (W, gw)
        # A device tensor divisor: division by a host scalar would multiply
        # by its reciprocal on CUDA.
        self._norm = torch.tensor([width, height], dtype=torch.float32, device=self.device)
        self.use_contrast_mask = use_contrast_mask
        self.mask_threshold = mask_threshold
        self.mask_dilate = mask_dilate
        self.use_rlof = use_rlof
        self.params = LKParams(levels=levels) if use_rlof else FlowParams(levels=levels)
        self._dense_flow = dense_flow_lk if use_rlof else dense_flow
        self.plain = plain

    def flow(self, prev_gray, gray, prev_flow) -> torch.Tensor:
        """The dense flow ``prev_gray -> gray`` warm started at ``prev_flow``
        (leading dims flattened into the kernels' batch dim)."""
        h, w = self.shape
        lead = prev_gray.shape[:-2]
        flow = self._dense_flow(
            prev_gray.reshape(-1, h, w), gray.reshape(-1, h, w), self.params,
            prev_flow.reshape(-1, h, w, 2), self.plain,
        )
        return flow.reshape(lead + (h, w, 2))

    def _densify(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H, W) -> (..., gh, gw) cell sums ``syᵀ · x · sx``."""
        return torch.matmul(self._sy.T, torch.matmul(x, self._sx))

    def __call__(self, prev_gray, gray, prev_flow):
        if prev_gray.shape[-2:] != self.shape or gray.shape != prev_gray.shape:
            raise ValueError(f"CvFlowStep: expected frames of {self.shape}")
        flow = self.flow(prev_gray, gray, prev_flow)
        if self.use_contrast_mask:
            grad = torch.abs(sobel_xy(prev_gray))
            m = dilate_disk((grad > self.mask_threshold).to(torch.float32), self.mask_dilate)
        else:
            m = torch.ones_like(prev_gray)
        wf = flow / self._norm * m[..., None]
        sums = torch.stack([self._densify(wf[..., 0]), self._densify(wf[..., 1])], dim=-1)
        cnt = self._densify(m)
        grid = sums / torch.clamp(cnt, min=1.0)[..., None]
        return flow, grid, cnt > 0.5


@register("cv")
class CvDecoder:
    """Decoder computing dense flow on ``device`` from any libav source.

    The first frame has no predecessor: it returns an empty
    :class:`DecodedFrame` with ``has_mvs=False`` and sets a zero warm
    start, so every later frame runs the warm/zero guard.
    """

    def __init__(
        self,
        input_path: str,
        grid_max_dim: int = 150,
        use_contrast_mask: bool = True,
        levels: int = 5,
        mask_threshold: float = 20.0,
        mask_dilate: int = 2,
        use_rlof: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self._settings = dict(
            grid_max_dim=grid_max_dim, use_contrast_mask=use_contrast_mask,
            levels=levels, mask_threshold=mask_threshold, mask_dilate=mask_dilate,
            use_rlof=use_rlof,
        )
        # Imported here: CvFlowStep alone needs no FFmpeg.
        from ofps_torch.decoders.av import AvDecoder

        self._av = AvDecoder(input_path)
        self._step: Optional[CvFlowStep] = None
        self._grid_pos: Optional[np.ndarray] = None
        self._prev_gray = None
        self._prev_flow = None

    def _build(self, h: int, w: int) -> None:
        self._step = CvFlowStep(h, w, device=self.device, **self._settings)
        gw, gh = self._step.grid_wh
        ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        self._grid_pos = np.stack(
            [(xs + 0.5) / gw, (ys + 0.5) / gh], axis=-1
        ).reshape(-1, 2).astype(np.float32)

    def process_frame(
        self, want_frame: bool = False, skip: int = 0
    ) -> Optional[DecodedFrame]:
        f = self._av.process_frame(want_frame=True, skip=skip)
        if f is None:
            return None
        gray = rgb_to_gray(torch.from_numpy(f.frame[..., :3]).to(self.device))
        out_frame = f.frame if want_frame else None
        h, w = gray.shape
        if self._step is None:
            self._build(h, w)
        if self._prev_gray is None:
            self._prev_gray = gray
            self._prev_flow = torch.zeros((h, w, 2), dtype=torch.float32, device=self.device)
            return DecodedFrame(
                pos=np.zeros((0, 2), np.float32),
                motion=np.zeros((0, 2), np.float32),
                has_mvs=False,
                frame=out_frame,
            )
        flow, grid, valid = self._step(self._prev_gray, gray, self._prev_flow)
        self._prev_gray, self._prev_flow = gray, flow
        motion = grid.reshape(-1, 2).cpu().numpy()
        keep = valid.reshape(-1).cpu().numpy()
        return DecodedFrame(
            pos=self._grid_pos[keep], motion=motion[keep], has_mvs=True, frame=out_frame
        )

    def get_framerate(self) -> Optional[float]:
        return self._av.get_framerate()

    def get_aspect(self) -> Optional[Tuple[int, int]]:
        return self._av.get_aspect()

    def close(self) -> None:
        self._av.close()
