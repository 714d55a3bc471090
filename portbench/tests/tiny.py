"""The cells at a size that the CPU tests hold: the configurations with
coarse pillars and narrow layers, the traffic with few small frames."""
from __future__ import annotations

import copy

from portbench import configs

PP_TRAFFIC = dict(frames=2, spread={'points': [3000, 3200]},
                  pad_points=3328, pad_boxes=16, pool=4, clutter_points=400,
                  sample_groups={'Car': 6, 'Pedestrian': 4, 'Cyclist': 3},
                  warm_steps=1, trace_steps=2, log_interval=2)
CP_TRAFFIC = dict(frames=2, sweeps=3, azimuth_steps=360, pad_points=6528,
                  pad_boxes=32, pool=2,
                  spread={'objects': [8, 10], 'ego_speed_mps': [0.0, 12.0],
                          'street_half_width_m': [6.0, 25.0]},
                  warm_rounds=1, trace_requests=2)

def pp_config():
    cfg = copy.deepcopy(configs.load('pp_kitti_3class_kld'))
    m = cfg['model']
    m['voxel_size'] = [0.32, 0.32, 4.0]
    m['max_points_per_voxel'] = 8
    m['max_voxels_per_sample'] = 1500
    m['encoder_cfg']['feat_channels'] = [16]
    m['backbone_cfg'].update(in_channels=16, out_channels=[8, 16, 16],
                             layer_nums=[1, 1, 1])
    m['neck_cfg'].update(in_channels=[8, 16, 16], out_channels=[8, 8, 8])
    m['head_cfg']['feat_channels'] = 24
    return cfg


def cp_config():
    cfg = copy.deepcopy(configs.load('centerpoint_nus_gwd5'))
    m = cfg['model']
    m['voxel_size'] = [0.8, 0.8, 8.0]
    m['max_voxels_per_sample'] = 3000
    m['encoder_cfg']['feat_channels'] = [16]
    m['backbone_cfg'].update(in_channels=16, out_channels=[8, 16, 16],
                             layer_nums=[1, 1, 1])
    m['neck_cfg'].update(in_channels=[8, 16, 16], out_channels=[8, 8, 8])
    cfg['head']['out_size_factor'] = 4
    cfg['head']['test_cfg']['max_per_img'] = 32
    cfg['head']['test_cfg']['post_max_size'] = 40
    return cfg
