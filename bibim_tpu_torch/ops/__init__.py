"""The GPU-program layer: vertex stage, triangle setup, binning and the
four kernels (raster K1, sampled shade K2, pair sort K3, overlay K4),
material tables, shading and tone mapping."""
