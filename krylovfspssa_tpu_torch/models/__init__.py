from .expressions import compile_expression, parse_expression
from .model import Model, load_model

__all__ = ["Model", "load_model", "compile_expression", "parse_expression"]
