# Launchers of the port: the serving launcher so far.
