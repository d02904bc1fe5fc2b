"""Dataset set-up scripts of the port (counterpart of setup/): the
stage-1.5 bridge, which runs a trained RadarNet over the train, val or test
manifests and writes the quasi-dense depth and response FusionNet trains
on."""
