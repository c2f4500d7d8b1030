"""Asset loaders of the port (copies of the JAX package's numpy-only
``assets`` modules): binary FBX and OBJ meshes, PNG/JPG decode, PBR
material sets. Meshes load as ``scene.meshgen.Mesh``."""
