"""KITTI, ScanNet and SUN RGB-D info files for the port, without JAX.

    python -m dfm_tpu_torch.tools.create_data kitti --root data/kitti \\
        --splits train val
    python -m dfm_tpu_torch.tools.create_data scannet|sunrgbd --root R \\
        --splits train val

Port of the kitti branch of `tools/create_data.py:111-127`: reads
`ImageSets/{split}.txt` under the root (the frames of `training/image_2`
when it is absent) and writes `kitti_infos_{split}.pkl` with
`data/kitti.py:build_kitti_infos`, temporal sweeps from `prev_2/` and
`poses/` included. `--with-gt-db` also writes the cut-and-paste GT
database of the train split (`tools/create_data.py:128-138`,
`data/dbsampler.py:create_gt_database`): `dfm_gt_database/` and
`dfm_gt_database_infos.pkl` under the root, from each frame's velodyne
points in the pseudo-LiDAR frame, which `tools.train`'s
`KittiLidarSource` samples from.

`scannet` / `sunrgbd` are the indoor routes of `tools/create_data.py:59-80`
(`tools/data_converter/indoor_converter.py`): `{dataset}_infos_{split}.pkl`
under the root, and the `points/` bins (ScanNet's instance and semantic
masks too) that they name. S3DIS comes with the segmentation slice.
"""

import argparse
import glob
import os
import pickle
import sys

from ..data.dbsampler import create_gt_database
from ..data.kitti import KittiDataset, build_kitti_infos
from .data_converter import indoor_converter as ic


def split_ids(root, split):
    ids_file = os.path.join(root, 'ImageSets', f'{split}.txt')
    if os.path.exists(ids_file):
        with open(ids_file) as f:
            return [int(x) for x in f.read().split()]
    imgs = sorted(glob.glob(os.path.join(root, 'training', 'image_2',
                                         '*.png')))
    ids = [int(os.path.basename(x)[:-4]) for x in imgs]
    print(f'no ImageSets/{split}.txt; globbed {len(ids)} frames')
    return ids


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('dataset', choices=['kitti', 'scannet', 'sunrgbd'])
    p.add_argument('--root', default='data/kitti')
    p.add_argument('--splits', nargs='*', default=['train', 'val'])
    p.add_argument('--with-gt-db', action='store_true',
                   help='also build the cut-and-paste GT database from the '
                        'train split')
    args = p.parse_args(argv)
    if args.dataset != 'kitti':
        build = ic.build_sunrgbd_infos if args.dataset == 'sunrgbd' else \
            ic.build_scannet_infos
        for split in args.splits:
            infos = build(args.root, split)
            out = ic.write_infos(infos, os.path.join(
                args.root, f'{args.dataset}_infos_{split}.pkl'))
            print(f'wrote {len(infos)} infos -> {out}')
        return 0
    for split in args.splits:
        infos = build_kitti_infos(args.root, split_ids(args.root, split))
        out = os.path.join(args.root, f'kitti_infos_{split}.pkl')
        with open(out, 'wb') as f:
            pickle.dump(infos, f)
        print(f'wrote {len(infos)} infos -> {out}')
        if args.with_gt_db and split == 'train':
            ds = KittiDataset(args.root, infos, train=True)
            db = create_gt_database(infos, args.root, args.root,
                                    ds._load_points_pl)
            print(f'wrote GT database -> {db}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
