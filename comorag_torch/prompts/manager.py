"""Prompt template registry and renderer.

Capability parity with the reference's PromptTemplateManager
(prompts/prompt_template_manager.py:14-198): templates are either a single
``string.Template`` or a chat history whose contents are Templates;
``render(name, **vars)`` substitutes ``$var`` placeholders. Registration is
explicit (a dict in ``templates/catalog.py``) rather than directory
scanning — import side effects don't belong in a framework.

Copy of ``comorag_tpu/prompts/manager.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

from string import Template
from typing import Any, Dict, List, Union

ChatTemplate = List[Dict[str, Any]]


class PromptManager:
    def __init__(self, role_mapping: Dict[str, str] | None = None, extra: Dict[str, Any] | None = None):
        from comorag_torch.prompts.templates.catalog import TEMPLATE_CATALOG

        self.role_mapping = role_mapping or {}
        self.templates: Dict[str, Union[Template, ChatTemplate]] = {}
        for name, template in {**TEMPLATE_CATALOG, **(extra or {})}.items():
            self.register(name, template)

    def register(self, name: str, template) -> None:
        if isinstance(template, Template):
            self.templates[name] = template
        elif isinstance(template, str):
            self.templates[name] = Template(template)
        elif isinstance(template, list):
            chat: ChatTemplate = []
            for item in template:
                role = self.role_mapping.get(item["role"], item["role"])
                content = item["content"]
                chat.append({"role": role, "content": content if isinstance(content, Template) else Template(content)})
            self.templates[name] = chat
        else:
            raise TypeError(f"Template {name!r} must be str, Template, or chat list")

    def names(self) -> List[str]:
        return list(self.templates)

    def has(self, name: str) -> bool:
        return name in self.templates

    def render(self, name: str, **variables) -> Union[str, List[Dict[str, str]]]:
        if name not in self.templates:
            raise KeyError(f"Template {name!r} not found")
        template = self.templates[name]
        if isinstance(template, Template):
            return template.substitute(**variables)
        return [
            {"role": item["role"], "content": item["content"].substitute(**variables)}
            for item in template
        ]
