"""The camera-only Waymo GT .bin of converted infos, for LET-mAP.

    python -m dfm_tpu_torch.tools.create_waymo_gt_bin --infos INFOS.pkl \
        --out gt.bin [--no-cam-sync]

Port of the `--infos` route of `tools/create_waymo_gt_bin.py`: each
info's vehicle-frame boxes of the three classes with at least one LiDAR
point, with `cam_sync` (the default) only those some camera sees, as
Objects of score 0.5 (`evaluation/waymo_eval.py:gt_objects_from_infos`).
It reads the keys that the port's converter writes
(`tools/data_converter/waymo_converter.py`): the boxes under 'gt_boxes'
where JAX's tool reads 'gt_boxes_3d' (an info with 'gt_boxes_3d' is read
as JAX reads it), 'labels', 'camera_names', 'camera_synced_boxes_3d' and
'num_lidar_points'. JAX's `--tfrecord-dir` route needs the
waymo-open-dataset devkit and is not ported.
"""

import argparse
import pickle
import sys

from ..evaluation.waymo_eval import gt_annos_to_bin, gt_objects_from_infos


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--infos', required=True, help='converted info pkl')
    p.add_argument('--out', required=True)
    p.add_argument('--no-cam-sync', action='store_true')
    args = p.parse_args(argv)
    with open(args.infos, 'rb') as f:
        infos = pickle.load(f)
    n = gt_annos_to_bin(gt_objects_from_infos(
        infos, cam_sync=not args.no_cam_sync), args.out)
    print(f'wrote {n} GT objects -> {args.out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
