"""Dataset set-up scripts of the port (counterpart of setup/): stage 0,
which builds the lidar, radar and ground-truth files and their manifests
from the nuScenes DB (setup_dataset_nuscenes, its _test and
_with_denseGT forms, make_data_split), and the stage-1.5 bridge, which
runs a trained RadarNet over the train, val or test manifests and writes
the quasi-dense depth and response FusionNet trains on."""
