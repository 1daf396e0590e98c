"""The tile-sharded multi-device path (port of the JAX package's parallel/):
process groups and the sharded state in `mesh`, the strip rasterizer in
`raster`, the sharded train steps in `train`, and the multi-process entry
points in `dryrun`."""
