"""How each ``model_type`` of a configuration file is built: in the port
(its config object and loss) and in the reference. Found by name."""
