# Launchers of the port: cluster meshes, the serving and training drivers, the
# cluster dry run with its roofline terms and report tables.
