"""The L4 ADS benchmark of the paper (Fig. 1 / Fig. 10).

14 DNN tasks derived from industry & academia workloads, fed by four
sensor groups (multi-view cameras 30 Hz, stereo cameras 20 Hz, LiDAR
10 Hz, IMU 240 Hz).  Driving functions (perception -> localization ->
prediction -> planning -> control) target the actuator; four cockpit
monitoring modules (road semantics, depth, dynamic targets, optical
flow) target the display and are replicated x1/x6/x9 to scale load.

Per-task mean compute (GMACs/job) is estimated from the public profiles
of the cited models (ResNet18, YoloX, BEVFormer, Deformable-DETR, LAV,
ERFNet, PointPillars/CenterNet, PWC-Net, SemAttNet), scaled so that the
aggregate demand lands in the paper's stated 180-300 TMAC/s regime at
x6..x9 cockpit replication.  Bandwidth columns come straight from
Fig. 10.  ``checkpoint_bytes`` is the *per-tile* live state migrated on
a DoP switch (bounded by the 1.25 MB tile SRAM); the reallocation model
multiplies by the current DoP.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .workload import Chain, DnnTask, SensorTask, Workflow

__all__ = ["make_ads_benchmark", "COCKPIT_CHAINS", "ADS_TASK_TABLE"]

_GMAC = 2e9  # 1 GMAC = 2e9 FLOPs

# id, name, model, GMACs/job, avg BW frac, peak GB/s, per-tile ckpt MB, DoPs
# DoP candidate sets reflect §III-B2: upstream perception encoders are
# inherently larger and support high DoP; tail planning/control models
# parallelise poorly.
ADS_TASK_TABLE: List[Tuple[int, str, str, float, float, float, float, Tuple[int, ...]]] = [
    (1,  "traffic_light", "ResNet18(E)+brake",       12.0, 0.084, 14.4, 0.6, (1, 2, 4, 8)),
    (2,  "img_backbone",  "YoloX(E)",               480.0, 0.507, 17.1, 1.0, (16, 32, 64, 96, 128)),
    (3,  "cam_fusion",    "BevFormer(E)",           600.0, 0.190, 280.2, 1.1, (16, 32, 64, 96, 128, 192)),
    (4,  "vis_det",       "DeformableDETR(H)",      100.0, 0.017, 31.9, 0.8, (4, 8, 16, 32, 64)),
    (5,  "traj_pred",     "LAV",                     40.0, 0.013, 10.3, 0.7, (2, 4, 8, 16, 32)),
    (6,  "path_plan",     "LAV-plan",                10.0, 0.013, 1.0, 0.5, (1, 2, 4, 8, 16)),
    (7,  "control",       "LAV-ctrl",                 1.5, 0.001, 2.0, 0.3, (1, 2, 4)),
    (8,  "stereo_lidar",  "ERFNet(E)+PointPainting", 400.0, 0.054, 21.0, 1.0, (8, 16, 32, 64, 96)),
    (9,  "lane_seg",      "ERFNet(H)",               70.0, 0.049, 27.2, 0.8, (2, 4, 8, 16, 32)),
    (10, "lidar_det",     "PointPillars+CenterNet", 120.0, 0.012, 78.2, 0.9, (4, 8, 16, 32, 64)),
    (11, "drivable_seg",  "ERFNet(H)",               70.0, 0.037, 26.8, 0.8, (2, 4, 8, 16, 32)),
    (12, "semantic_seg",  "ERFNet(H)",               70.0, 0.025, 27.0, 0.8, (2, 4, 8, 16, 32)),
    (13, "optical_flow",  "PWC-NET(H)",              90.0, 0.010, 4.8, 0.8, (2, 4, 8, 16, 32)),
    (14, "depth_est",     "SemAttNet(H)",           150.0, 0.025, 15.3, 0.9, (4, 8, 16, 32, 64)),
]

# chains whose replication scales the cockpit load (nodes 11-14 and their
# private heads; upstream backbones/sensors stay shared)
COCKPIT_CHAINS = ("ck_drivable", "ck_semantic", "ck_flow", "ck_depth")


def make_ads_benchmark(
    cockpit_replicas: int = 1,
    load_factor: float = 1.0,
    critical_deadline_s: float = 0.100,
    cockpit_deadline_s: float = 0.100,
) -> Workflow:
    """Build the benchmark workflow.

    ``cockpit_replicas`` in {1, 4, 6, 9} reproduces the paper's workload
    scaling; ``load_factor`` scales every DNN's mean compute (the paper's
    {0.5, 1.0} sweep); deadlines follow §V-A (80/90/100 ms critical).
    """
    tasks: Dict[str, DnnTask] = {}
    for _id, name, model, gmacs, bw, peak, ckpt_mb, dops in ADS_TASK_TABLE:
        tasks[name] = DnnTask(
            name=name,
            mean_flops=gmacs * _GMAC * load_factor,
            checkpoint_bytes=ckpt_mb * 1e6,
            avg_bw_frac=bw,
            peak_bw=peak * 1e9,
            compiled_dops=dops,
            model=model,
        )

    sensors = {
        "cam_multi": SensorTask(
            name="cam_multi", period_s=1.0 / 30.0, mean_latency_s=2.0e-3
        ),
        "cam_stereo": SensorTask(
            name="cam_stereo", period_s=1.0 / 20.0, mean_latency_s=2.5e-3
        ),
        "lidar": SensorTask(name="lidar", period_s=1.0 / 10.0, mean_latency_s=4.0e-3),
        "imu": SensorTask(name="imu", period_s=1.0 / 240.0, mean_latency_s=0.1e-3),
    }

    all_tasks: Dict[str, DnnTask] = {**sensors, **tasks}

    edges = [
        # sensing -> perception
        ("cam_multi", "traffic_light"),
        ("cam_multi", "img_backbone"),
        ("cam_multi", "optical_flow"),
        ("cam_stereo", "stereo_lidar"),
        ("cam_stereo", "depth_est"),
        ("lidar", "stereo_lidar"),
        ("lidar", "lidar_det"),
        ("lidar", "depth_est"),
        # perception internal
        ("img_backbone", "cam_fusion"),
        ("cam_fusion", "vis_det"),
        # backbone heads (cockpit)
        ("img_backbone", "lane_seg"),
        ("img_backbone", "drivable_seg"),
        ("img_backbone", "semantic_seg"),
        # localization/prediction
        ("imu", "traj_pred"),
        ("vis_det", "traj_pred"),
        ("stereo_lidar", "traj_pred"),
        ("lidar_det", "traj_pred"),
        # planning/control
        ("traj_pred", "path_plan"),
        ("traffic_light", "path_plan"),
        ("path_plan", "control"),
    ]

    chains = [
        Chain(
            "drv_vision",
            ("cam_multi", "img_backbone", "cam_fusion", "vis_det",
             "traj_pred", "path_plan", "control"),
            critical_deadline_s, critical=True,
        ),
        Chain(
            "drv_lidar",
            ("lidar", "lidar_det", "traj_pred", "path_plan", "control"),
            critical_deadline_s, critical=True,
        ),
        Chain(
            "drv_fusion",
            ("cam_stereo", "stereo_lidar", "traj_pred", "path_plan", "control"),
            critical_deadline_s, critical=True,
        ),
        Chain(
            "drv_light",
            ("cam_multi", "traffic_light", "path_plan", "control"),
            critical_deadline_s, critical=True,
        ),
        Chain(
            "ck_lane",
            ("cam_multi", "img_backbone", "lane_seg"),
            cockpit_deadline_s, critical=False,
        ),
        Chain(
            "ck_drivable",
            ("cam_multi", "img_backbone", "drivable_seg"),
            cockpit_deadline_s, critical=False,
        ),
        Chain(
            "ck_semantic",
            ("cam_multi", "img_backbone", "semantic_seg"),
            cockpit_deadline_s, critical=False,
        ),
        Chain(
            "ck_flow",
            ("cam_multi", "optical_flow"),
            cockpit_deadline_s, critical=False,
        ),
        Chain(
            "ck_depth",
            ("cam_stereo", "depth_est"),
            cockpit_deadline_s, critical=False,
        ),
    ]

    wf = Workflow(tasks=all_tasks, edges=edges, chains=chains)
    if cockpit_replicas > 1:
        wf = wf.replicate_cockpit(cockpit_replicas, COCKPIT_CHAINS)
    return wf
