"""The GPU-program layer: vertex stage, triangle setup, binning and the
kernels (raster K1, sampled shade K2, pair sort K3, overlay K4, G-buffer
shade K5, block-table K6 and small-table K7 samplers), material tables,
shading, the shadow map, image-based lighting and tone mapping."""
