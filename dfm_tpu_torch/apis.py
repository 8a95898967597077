"""Inference entry points. Port of `dfm_tpu/apis.py:18-217` (with the
mono family's `init_mono_model` / `inference_mono_3d`: FCOS3D, PGD, SMOKE
and MonoFlex),
MultiViewDfM's (`init_mvdfm_model`, `detect_multiview_sample`,
`multihost_multiview_inference`), ImVoxelNet's
(`init_imvoxelnet_model`) and the SECOND LiDAR family's
(`init_lidar_model`: VoxelNet, DynamicVoxelNet).

They run on the CUDA card by default and raise when there is none; the
CPU is used only when the caller passes device='cpu'. Weights are
random from seed 0 (`utils/weights.py:init_weights`) until a
reference-layout checkpoint is loaded with the handle's
`load_checkpoint(path)` (the counterpart of the JAX handle's `restore`).
`inference_dfm` runs one pipeline sample (`data/pipeline.py`) to a KITTI
anno dict, `dataset_inference` (`multihost_dataset_inference`, the JAX
package's name) a whole dataset (`data/kitti.py`), its frames shared among
the processes of a torchrun group (`parallel/dist.py`) and the results
gathered on every one.

`use_band` and `packed` select the form of the 3D trunks
(`models/backbones/dfm_backbone.py`). The default (`packed=None`) is, for
bfloat16, the full conv chain: banded stems, reduced-depth mono trunk,
and both trunks in the chain format from the cost volume to the pred
exit (kernels K4-K8b), where the shapes allow it; `packed=True` asks for
it in any dtype (float32 on the CPU only) and warns when a trunk's
shapes send it to the `'stem'` form. `packed='stem'` keeps only
the stereo stem and pred ConvNorm on the chain (K4, K7a, K8a),
`packed=False` is the banded form without the chain, `use_band=False,
packed=False` the dense form. One state dict loads into every form.
"""

import numpy as np
import torch
import torch.distributed as dist

from .data.collate import build_batch
from .data.pipeline import normalize_image
from .evaluation.results import detections_to_kitti_annos
from .models.builder import mono_class
from .models.detectors.dfm import DfM, DfMConfig, dfm_predict
from .models.detectors.imvoxelnet import (ImVoxelNet, ImVoxelNetConfig,
                                          imvoxelnet_predict)
from .models.heads.fcos_mono3d import FCOS3DConfig, pad44
from .models.detectors.dynamic_voxelnet import (DynamicVoxelNet,
                                                DynamicVoxelNetConfig)
from .models.detectors.multiview_dfm import (MultiViewDfM, MVDfMConfig,
                                             mvdfm_predict)
from .models.detectors.voxelnet import (VoxelNet, VoxelNetConfig,
                                        voxelnet_predict)
from .parallel import dist as D
from .utils.weights import init_weights, load_reference_checkpoint

__all__ = ['init_dfm_model', 'init_dfm_stream', 'detect_sample',
           'inference_dfm', 'dataset_inference',
           'multihost_dataset_inference', 'allgather_pickled',
           'init_mvdfm_model', 'detect_multiview_sample',
           'multihost_multiview_inference', 'init_imvoxelnet_model',
           'init_lidar_model', 'init_mono_model',
           'inference_mono_3d', 'detect_mono']


def _device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('dfm_tpu_torch runs on a CUDA device; pass '
                               "device='cpu' to run on the CPU")
        return torch.device('cuda')
    return torch.device(device)


def _build(cfg, dtype, device, use_band, packed):
    cfg = cfg or DfMConfig()
    device = _device(device)
    with torch.device('meta'):
        model = DfM(cfg, dtype=dtype, use_band=use_band, packed=packed)
    model = init_weights(model.to_empty(device=device)).eval()
    return cfg, device, model


def init_dfm_model(cfg=None, dtype=torch.bfloat16, device=None,
                   use_band=True, packed=None):
    """Build a DfM model and its inference function.

    Returns dict(model, cfg, device, infer, load_checkpoint) with
    infer(img (B, 2, H, W, 3), meta) -> padded detections dict and
    load_checkpoint(path) -> the checkpoint keys it did not take
    (`utils/weights.py:load_reference_checkpoint`).
    """
    cfg, device, model = _build(cfg, dtype, device, use_band, packed)

    @torch.inference_mode()
    def infer(img, meta):
        return dfm_predict(model(img, meta), cfg)

    return dict(model=model, cfg=cfg, device=device, infer=infer,
                load_checkpoint=lambda path: load_reference_checkpoint(
                    model, path))


def init_dfm_stream(cfg=None, dtype=torch.bfloat16, device=None,
                    use_band=True, packed=None):
    """Streaming video inference with prev-frame feature reuse: the first
    frame of a sequence runs the two-frame path, every later step one
    backbone + neck pass on the new frame and the cached stereo features
    of the previous one (exact when consecutive frames share
    scale / flip).

    Returns dict(model, cfg, device, infer_first, infer_stream,
    load_checkpoint):
        infer_first(img2 (B, 2, H, W, 3), meta) -> (dets, cache)
        infer_stream(img1 (B, H, W, 3), meta, cache) -> (dets, cache)
        load_checkpoint(path), as `init_dfm_model`'s
    """
    cfg, device, model = _build(cfg, dtype, device, use_band, packed)

    @torch.inference_mode()
    def infer_first(img, meta):
        out = model(img, meta)
        return dfm_predict(out, cfg), out['stereo_cache']

    @torch.inference_mode()
    def infer_stream(img_cur, meta, cache):
        img2 = torch.stack([img_cur, img_cur], dim=1)
        out = model(img2, meta, prev_stereo_cache=cache)
        return dfm_predict(out, cfg), out['stereo_cache']

    return dict(model=model, cfg=cfg, device=device,
                infer_first=infer_first, infer_stream=infer_stream,
                load_checkpoint=lambda path: load_reference_checkpoint(
                    model, path))


def detect_sample(handle, sample):
    """One pipeline sample (`load_video_sample`'s dict) through an
    `init_dfm_model` handle -> its padded detections as numpy arrays
    (one move to the host, which waits for the device)."""
    img, meta, _ = build_batch([sample], handle['device'])
    det = handle['infer'](img, meta)
    return {k: v[0].cpu().numpy() for k, v in det.items()}


def inference_dfm(handle, sample):
    """Run DfM on one pipeline sample -> a KITTI anno dict, boxes
    projected with the original P2 and clipped to (0.3 org_w, org_w), as
    `dfm_tpu/apis.py:55-75` clips them."""
    org_w = sample['org_w']
    return detections_to_kitti_annos(
        detect_sample(handle, sample), np.asarray(sample['ori_cam2img'])[:3],
        (int(org_w * 0.3), int(org_w)))


def allgather_pickled(obj):
    """One picklable object per process of the group -> the list of them
    in rank order, on every process (`dist.all_gather_object`; the
    reference's collect_results). [obj] without a group."""
    if not D.is_active():
        return [obj]
    out = [None] * D.world_size()
    dist.all_gather_object(out, obj)
    return out


def _sharded(n, infer_one):
    """infer_one(i) for i in range(rank, n, world) on each process, the
    results gathered to every process in index order."""
    world, rank = D.world_size(), D.rank()
    mine = {i: infer_one(i) for i in range(rank, n, world)}
    out = [None] * n
    for shard in allgather_pickled(mine):
        for i, r in shard.items():
            out[i] = r
    return out


def dataset_inference(handle, dataset, max_samples=None):
    """Loop a dataset (`data/kitti.py:KittiDataset`) -> its KITTI annos,
    one per frame, drawing the pipeline's crops from
    `np.random.default_rng(0)` as the JAX package does. In a process group
    (the reference's multi_gpu_test) process r infers frames r, r + world,
    ... and every process gets the whole dataset-ordered list: each of the
    evaluation pipeline's draws has one possible value, so a shard's
    samples are the ones one process makes."""
    rng = np.random.default_rng(0)
    n = min(len(dataset), max_samples or len(dataset))
    return _sharded(n, lambda i: inference_dfm(
        handle, dataset.get_sample(i, rng)))


# the JAX package's name for the loop over a group's processes
multihost_dataset_inference = dataset_inference


def init_mvdfm_model(cfg=None, dtype=torch.bfloat16, device=None):
    """Build a MultiViewDfM model (seeded random weights) and its
    inference function.

    Returns dict(model, cfg, device, infer, load_checkpoint) with
    infer(imgs (B, F, V, H, W, 3), lidar2img (B, F, V, 4, 4)) -> padded
    detections dict in the vehicle frame and load_checkpoint(path) ->
    the keys of a checkpoint in the port's layout that it did not take.
    """
    cfg = cfg or MVDfMConfig()
    device = _device(device)
    with torch.device('meta'):
        model = MultiViewDfM(cfg, dtype=dtype)
    model = init_weights(model.to_empty(device=device)).eval()

    @torch.inference_mode()
    def infer(imgs, lidar2img):
        return mvdfm_predict(model(imgs, lidar2img), cfg)

    return dict(model=model, cfg=cfg, device=device, infer=infer,
                load_checkpoint=lambda path: load_reference_checkpoint(
                    model, path))


def detect_multiview_sample(handle, sample):
    """One `data/waymo.py:assemble_multiview_sample` dict through an
    `init_mvdfm_model` handle -> its kept detections in the vehicle
    (lidar) frame as numpy arrays: 'boxes_3d' (N, 7) bottom-centre,
    'scores_3d' (N,), 'labels_3d' (N,) (one move to the host, which waits
    for the device). The anchor head's are those of its mask, the
    CenterHead's those of a score above 0."""
    dev = handle['device']
    det = handle['infer'](
        torch.as_tensor(sample['imgs'], device=dev)[None],
        torch.as_tensor(sample['lidar2img'], device=dev)[None])
    if 'scores_3d' in det:                  # CenterHead: sample 0, padded
        det = {k: v.cpu().numpy() for k, v in det.items()}
        keep = det['scores_3d'] > 0
        return {k: v[keep] for k, v in det.items()}
    det = {k: v[0].cpu().numpy() for k, v in det.items()}
    keep = det['mask'].astype(bool)
    return dict(boxes_3d=det['boxes3d'][keep], scores_3d=det['scores'][keep],
                labels_3d=det['labels'][keep])


def multihost_multiview_inference(handle, dataset, max_samples=None):
    """`detect_multiview_sample` over the frames of a Waymo dataset
    (`data/waymo.py:WaymoDataset`), shared among the processes of a group
    as `multihost_dataset_inference` shares them -> the dataset-ordered
    list of kept detections on every process (one process: every frame in
    order)."""
    n = min(len(dataset), max_samples or len(dataset))
    return _sharded(n, lambda i: detect_multiview_sample(
        handle, dataset.get_sample(i)))


def init_imvoxelnet_model(cfg=None, dtype=torch.bfloat16, device=None):
    """Build an ImVoxelNet model (seeded random weights) and its
    inference function.

    Returns dict(model, cfg, device, infer, load_checkpoint) with
    infer(imgs (B, H, W, 3) normalised, lidar2img (B, 4, 4)) -> padded
    detections in the lidar frame ('boxes3d' bottom-centre, 'scores',
    'labels', 'mask') and load_checkpoint(path) -> the keys of a
    checkpoint in the port's layout that it did not take.
    """
    cfg = cfg or ImVoxelNetConfig()
    device = _device(device)
    with torch.device('meta'):
        model = ImVoxelNet(cfg, dtype=dtype)
    model = init_weights(model.to_empty(device=device)).eval()

    @torch.inference_mode()
    def infer(imgs, lidar2img):
        return imvoxelnet_predict(model(imgs, lidar2img), cfg)

    return dict(model=model, cfg=cfg, device=device, infer=infer,
                load_checkpoint=lambda path: load_reference_checkpoint(
                    model, path))


def init_lidar_model(cfg=None, dtype=torch.bfloat16, device=None):
    """Build a VoxelNet (a `VoxelNetConfig`, the default) or a
    DynamicVoxelNet (a `DynamicVoxelNetConfig`), seeded random weights,
    and its inference function.

    Returns dict(model, cfg, device, infer, load_checkpoint) with
    infer(points (B, P, 3+), point_mask (B, P)) -> padded detections in
    the LiDAR frame ('boxes3d' bottom-centre, 'scores', 'labels', 'mask')
    and load_checkpoint(path) -> the keys of a checkpoint in the port's
    layout that it did not take.
    """
    cfg = cfg or VoxelNetConfig()
    device = _device(device)
    cls = DynamicVoxelNet if isinstance(cfg, DynamicVoxelNetConfig) \
        else VoxelNet
    with torch.device('meta'):
        model = cls(cfg, dtype=dtype)
    model = init_weights(model.to_empty(device=device)).eval()

    @torch.inference_mode()
    def infer(points, point_mask):
        return voxelnet_predict(model(points, point_mask), cfg)

    return dict(model=model, cfg=cfg, device=device, infer=infer,
                load_checkpoint=lambda path: load_reference_checkpoint(
                    model, path))


def init_mono_model(cfg=None, backbone_depth=None, dtype=torch.bfloat16,
                    device=None):
    """Build an FCOS3D (`FCOS3DConfig`, the default), a PGD (`PGDConfig`),
    an SMOKE (`SMOKEConfig`) or a MonoFlex (`MonoFlexConfig`) mono model,
    seeded random weights, and its inference function. `backbone_depth`:
    the ResNet's (101 if None); SMOKE and MonoFlex take 34 (DLA-34).

    Returns dict(model, cfg, device, infer, load_checkpoint) with
    infer(img (B, H, W, 3) normalised, cam2img (B, 3|4, 4)) -> padded
    camera-frame detections ('boxes3d' bottom-centre, 'scores',
    'labels', 'mask') and load_checkpoint(path) -> the keys of a
    checkpoint in the port's layout it did not take.
    """
    cfg = cfg or FCOS3DConfig()
    device = _device(device)
    depth = {} if backbone_depth is None else dict(
        backbone_depth=backbone_depth)
    with torch.device('meta'):
        model = mono_class(cfg)(cfg, dtype=dtype, **depth)
    model = init_weights(model.to_empty(device=device)).eval()

    @torch.inference_mode()
    def infer(img, cam2img):
        return model.predict(model(img), tuple(img.shape[1:3]), cam2img)

    return dict(model=model, cfg=cfg, device=device, infer=infer,
                load_checkpoint=lambda path: load_reference_checkpoint(
                    model, path))


def _infer_mono(handle, img, cam2img):
    """A normalised (H, W, 3) numpy image and its (3|4, 4) intrinsics ->
    the padded detections of the image (batch of one, on the device)."""
    dev = handle['device']
    img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    cam = pad44(torch.as_tensor(np.asarray(cam2img, np.float32)))
    return handle['infer'](img[None].to(dev), cam[None].to(dev))


def inference_mono_3d(handle, image, cam2img):
    """One image through an `init_mono_model` handle (reference
    `inference_mono_3d_detector`): `image` (H, W, 3) raw BGR, uint8 or
    float; `cam2img` (3, 3|4) or (4, 4). Returns the padded camera-frame
    detections of the image (batch of one, on the device)."""
    return _infer_mono(handle, normalize_image(np.asarray(image, np.float32)),
                       cam2img)


def detect_mono(handle, img, cam2img):
    """`inference_mono_3d` of an image as the model takes it: normalised
    (`data/kitti_mono.py:load_mono_image`), or raw as the nuScenes
    evaluation gives it (`tools/test.py:nuscenes_mono_eval`); the
    detections moved to the host as numpy arrays (the move waits for the
    device)."""
    return {k: v[0].cpu().numpy()
            for k, v in _infer_mono(handle, img, cam2img).items()}
