"""Model adapters, one file per ``arch`` a configuration names: the
benchmark's parameter layout, its plain reference and costs, and how the
port builds the model from the configuration's file."""
