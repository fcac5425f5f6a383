from .selector import Selector
from .selector_eui import SelectorEui
from .selector_spice import SelectorSpice

__all__ = ["Selector", "SelectorEui", "SelectorSpice"]
