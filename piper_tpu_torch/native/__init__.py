"""The native ONNX parser (onnx_parser.cpp) and its build."""
