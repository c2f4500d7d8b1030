"""Asset loaders of the port (copies of the JAX package's numpy-only
``assets`` modules): binary FBX and OBJ meshes, PNG/JPG decode, PBR
material sets, the concurrent image loader, PNG output and the on-disk
asset cache. Meshes load as ``scene.meshgen.Mesh``."""
