"""Stage-0 geometry of the port (counterpart of rcfd_tpu/geometry): pose
chains and the pinhole projection, rasterization with a scatter-min
z-buffer, depth-map reprojection, and the nuScenes adapter that drives
them (nuscenes_adapter, devkit imported only where a record is read from
disk)."""

from .transforms import (quaternion_to_rotation_matrix, pose_matrix, compose,
                         transform_points, sensor_to_camera_matrix,
                         camera_to_sensor_matrix, view_points,
                         project_points_to_image, backproject_to_camera)
from .rasterize import (points_to_depth_map, z_buffer_merge, zero_boxes,
                        zero_mask, depth_map_to_points)
